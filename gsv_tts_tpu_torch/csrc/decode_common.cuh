// Device code shared by the decode kernels (K1 whole B=1 step, K2 whole
// batched step, K3 flash decode attention, K5 and K6 layer stacks):
// warp/block reductions, the single-query attention walk over a cache and
// the sampling chain of one logits row.  Each .cu that includes this is
// built into its own library, so everything here is static.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define DEC_NEG (-1e30f)
#define DEC_MAX_SUPPRESSED 8

constexpr int SAMPLE_THREADS = 1024;

// error bits a kernel may set in its ``err`` word
constexpr int ERR_LAST_TOK = 1;  // last_tok outside [0, V)
constexpr int ERR_KV_LEN = 2;    // kv_len outside [0, S)
constexpr int ERR_PE_IDX = 4;    // positional index outside [0, P)
// (bit 8 is K4's: prefill lengths outside the prompt block, k4_flash_prefill.cu)
constexpr int ERR_SYNC = 16;     // a wait inside a persistent kernel gave up

// One layer's weights: matrices [out, in] and biases in bf16, LayerNorm
// affines in float32.
struct LayerWeights {
  const bf16* qkv_w;  // [3D, D]
  const bf16* qkv_b;  // [3D]
  const bf16* out_w;  // [D, D]
  const bf16* out_b;
  const bf16* mlp1_w;  // [M, D]
  const bf16* mlp1_b;
  const bf16* mlp2_w;  // [D, M]
  const bf16* mlp2_b;
  const float* ln1_g;
  const float* ln1_b;
  const float* ln2_g;
  const float* ln2_b;
};

// What every row of a step shares in the sampling chain.
struct SampleParams {
  int V, NP, S;  // vocabulary, next power of two, tok_buf row length
  int n_suppressed;
  int suppressed[DEC_MAX_SUPPRESSED];
  int use_prev;
  float rep_penalty, top_p, inv_temperature;
  int top_k;
};

#define DEC_CHECK()                                  \
  do {                                               \
    const cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the total.  ``red`` holds 32 floats.
static __device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float t = lane < nw ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

static __device__ __forceinline__ void bf16x8_to_float(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 a = __bfloat1622float2(p2[j]);
    f[2 * j] = a.x;
    f[2 * j + 1] = a.y;
  }
}

// ---------------------------------------------------------------------------
// Single-query attention over a cache (flash-decoding): the walk that K3's
// blocks and the persistent kernel's attention phase share.  A group of NT
// threads walks rows [s_begin, s_end) of the n_cache cache rows and, when
// has_own is set, the token's own row n_cache.  A row is read by LPR = Dh/8
// lanes, 16 bytes each, so a warp covers 32/LPR rows per step.  Every (warp,
// row slot) -- the LPR lanes that share lane / LPR -- leaves the running
// maximum m, the sum l and its 8 unnormalised outputs acc of the rows it met
// (m = -inf, l = 0 where it met none), which the caller merges.  The group
// walks STEP rows at a time; the loads of BATCH steps are issued together,
// so that it waits for device memory once per BATCH steps.  Rows at or past
// n_cache are never read.
//   qr          this lane's 8 query values: dims (lane % LPR) * 8 ... + 7
//   kown, vown  the same 8 dims of the token's own K/V (read when has_own)
//   kc, vc      the slot's cache rows of this layer, offset to this head
//   tid         the thread's index in the group
// ---------------------------------------------------------------------------
template <int LPR, int NT, int BATCH = 4>
static __device__ __forceinline__ void attn_walk(
    const float (&qr)[8], const float (&kown)[8], const float (&vown)[8], bool has_own,
    const bf16* __restrict__ kc, const bf16* __restrict__ vc, int row_stride, int n_cache,
    int s_begin, int s_end, float scale, int tid, float& m, float& l, float (&acc)[8]) {
  constexpr int RPW = 32 / LPR;  // rows per warp step
  constexpr int STEP = (NT / 32) * RPW;
  const int lane = tid & 31, warp = tid >> 5;
  const int d0 = (lane % LPR) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  m = -INFINITY;
  l = 0.f;
  const int n_load = min(n_cache, s_end);
#pragma unroll 1
  for (int s0 = s_begin + warp * RPW; s0 < s_end; s0 += BATCH * STEP) {  // warp-uniform
    const int s_first = s0 + lane / LPR;
    uint4 kr[BATCH], vr[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int s = s_first + i * STEP;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (s < n_load) {
        kr[i] = *reinterpret_cast<const uint4*>(kc + (size_t)s * row_stride + d0);
        vr[i] = *reinterpret_cast<const uint4*>(vc + (size_t)s * row_stride + d0);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int s = s_first + i * STEP;
      if (s0 + i * STEP >= s_end) break;  // warp-uniform: the shuffles below stay whole
      float kf[8], vf[8];
      bf16x8_to_float(kr[i], kf);
      bf16x8_to_float(vr[i], vf);
      if (has_own && s == n_cache) {  // the token itself
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          kf[j] = kown[j];
          vf[j] = vown[j];
        }
      }
      float part_dot = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) part_dot += qr[j] * kf[j];
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        part_dot += __shfl_xor_sync(0xffffffffu, part_dot, o);
      if (s < s_end) {
        const float score = part_dot * scale;
        const float m_new = fmaxf(m, score);
        // (__expf: two instructions against expf's fifteen, twice a step in a
        // loop that waits for instruction issue; its error, 2 ulp at these
        // arguments <= 0, is far below a bf16 cache row's)
        const float corr = __expf(m - m_new);
        const float p = __expf(score - m_new);
        l = l * corr + p;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = acc[j] * corr + p * vf[j];
        m = m_new;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Sampling of one logits row by one block of SAMPLE_THREADS threads:
// suppression -> repetition penalty -> top-p on the pre-temperature row ->
// temperature -> top-k pivot -> argmax(row + g).  A top-p cut sorts the row
// in shared memory (bitonic, value descending, ties to the lowest id -- the
// TPU kernels peel maxima with ties to the lowest lane) and the top-k pivot
// is read off that order; without one the pivot comes from a radix select
// (sample_kth_largest), a twentieth of the sort's barriers.  The filtered
// row overwrites ``row``; the token goes to tok_out[0] and is appended to
// tok_buf[buf_len] (tok_buf is this row's S entries).  Dynamic shared
// memory: sample_smem_bytes(V, NP).
// ---------------------------------------------------------------------------
static __device__ __forceinline__ bool sample_before(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Floats as unsigned keys of the same order (-inf lowest), and back.
static __device__ __forceinline__ unsigned sample_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

static __device__ __forceinline__ float sample_unkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The k-th largest (k >= 1, duplicates counted) of r[0, V): a radix select
// over the keys' four bytes -- a histogram of the candidates' next byte in
// shared memory (integer atomics: the counts do not depend on their order),
// then one warp finds the bin the k-th falls into.  Four passes of three
// block barriers against the 66 of a bitonic sort of the padded row, which
// only a top-p cut needs.  ``hist`` holds 256 ints, ``pick`` 2.
static __device__ float sample_kth_largest(const float* r, int V, int k, int* hist, int* pick) {
  const int tid = threadIdx.x, nt = blockDim.x;
  unsigned prefix = 0u, mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += nt) hist[i] = 0;
    __syncthreads();
    for (int i = tid; i < V; i += nt) {
      const unsigned key = sample_key(r[i]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1);
    }
    __syncthreads();
    if (tid < 32) {  // lane l owns bins 255 - 8 l down to 248 - 8 l
      int mine = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) mine += hist[255 - 8 * tid - j];
      int above = mine;  // inclusive sum over the lanes before this one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, above, o);
        if (tid >= o) above += t;
      }
      above -= mine;  // candidates in bins above this lane's
      if (above < k && k <= above + mine) {  // exactly one lane
        int bin = 255 - 8 * tid;
        while (above + hist[bin] < k) above += hist[bin--];
        pick[0] = bin;
        pick[1] = k - above;
      }
    }
    __syncthreads();
    prefix |= (unsigned)pick[0] << shift;
    mask |= 255u << shift;
    k = pick[1];
    // (pick is rewritten only after the next pass's two barriers)
  }
  return sample_unkey(prefix);
}

static __device__ void sample_row(const SampleParams& a, float* __restrict__ row,
                                  const float* __restrict__ gumbel, int* tok_buf,
                                  int* tok_out, int buf_len, bool suppress) {
  extern __shared__ float smem[];
  const int V = a.V, NP = a.NP;
  float* r = smem;                                   // [V]
  float* key = r + V;                                // [NP]
  int* idx = reinterpret_cast<int*>(key + NP);       // [NP]
  int* flag = idx + NP;                              // [V]
  float* scan = reinterpret_cast<float*>(flag + V);  // [SAMPLE_THREADS]
  __shared__ float red[32];
  __shared__ int s_first;
  __shared__ float s_bv[32];
  __shared__ int s_bi[32];
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < V; i += nt) r[i] = row[i];
  __syncthreads();
  if (suppress && tid < a.n_suppressed) {
    const int sid = a.suppressed[tid];
    if (sid >= 0 && sid < V) r[sid] = DEC_NEG;
  }
  __syncthreads();

  if (a.use_prev && a.rep_penalty != 1.f) {
    for (int i = tid; i < V; i += nt) flag[i] = 0;
    __syncthreads();
    for (int j = tid; j < buf_len; j += nt) {
      const int t = tok_buf[j];
      if (t >= 0 && t < V) flag[t] = 1;
    }
    __syncthreads();
    for (int i = tid; i < V; i += nt)
      if (flag[i]) r[i] = r[i] < 0.f ? r[i] * a.rep_penalty : r[i] / a.rep_penalty;
    __syncthreads();
  }

  const bool need_top_p = a.top_p < 1.f;
  const int k = min(a.top_k, V);
  const bool need_top_k = k < V;
  int n_keep = V;
  float kth = DEC_NEG;  // the k-th largest of the filtered, unscaled row
  if (need_top_k && !need_top_p) {
    int* hist = reinterpret_cast<int*>(scan);  // (free here: SAMPLE_THREADS entries)
    kth = sample_kth_largest(r, V, k, hist, hist + 256);
  } else if (need_top_p) {  // the cut needs the order itself
    for (int i = tid; i < NP; i += nt) {
      key[i] = i < V ? r[i] : -INFINITY;
      idx[i] = i;
    }
    __syncthreads();
    for (int size = 2; size <= NP; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < NP; i += nt) {
          const int j = i ^ stride;
          if (j > i) {
            const bool up = (i & size) == 0;
            const bool swap = up ? sample_before(key[j], idx[j], key[i], idx[i])
                                 : sample_before(key[i], idx[i], key[j], idx[j]);
            if (swap) {
              const float tk = key[i]; key[i] = key[j]; key[j] = tk;
              const int ti = idx[i]; idx[i] = idx[j]; idx[j] = ti;
            }
          }
        }
        __syncthreads();
      }
    }

    {
      const float mx = key[0];
      float zs = 0.f;
      for (int j = tid; j < V; j += nt) zs += expf(key[j] - mx);
      const float z = block_sum(zs, red);
      // inclusive prefix sum of the sorted probabilities: each thread owns
      // one contiguous run, the run totals are scanned across the block
      const int chunk = (V + nt - 1) / nt;
      const int lo = min(tid * chunk, V), hi = min(lo + chunk, V);
      float local = 0.f;
      for (int j = lo; j < hi; ++j) local += expf(key[j] - mx) / z;
      scan[tid] = local;
      if (tid == 0) s_first = V;
      __syncthreads();
      for (int off = 1; off < nt; off <<= 1) {
        const float add = tid >= off ? scan[tid - off] : 0.f;
        __syncthreads();
        scan[tid] += add;
        __syncthreads();
      }
      float run = tid > 0 ? scan[tid - 1] : 0.f;
      for (int j = lo; j < hi; ++j) {
        run += expf(key[j] - mx) / z;
        if (j > 0 && run > a.top_p) {
          atomicMin(&s_first, j);
          break;
        }
      }
      __syncthreads();
      n_keep = s_first;
      for (int j = tid; j < V; j += nt)
        if (j >= n_keep) r[idx[j]] = DEC_NEG;
      __syncthreads();
    }
    // kept entries are a prefix of the sorted order, everything past it is -1e30
    if (k - 1 < n_keep) kth = key[k - 1];
  }

  for (int i = tid; i < V; i += nt) r[i] = r[i] * a.inv_temperature;
  __syncthreads();
  if (need_top_k) {
    // scaling by 1/temperature is monotone, so the scaled pivot is the
    // scaled k-th largest
    const float pivot = kth * a.inv_temperature;
    for (int i = tid; i < V; i += nt)
      if (r[i] < pivot) r[i] = DEC_NEG;
    __syncthreads();
  }

  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = tid; i < V; i += nt) {
    row[i] = r[i];
    const float t = r[i] + gumbel[i];
    if (t > bv || (t == bv && i < bi)) {
      bv = t;
      bi = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int lane = tid & 31, wid = tid >> 5;
  if (lane == 0) {
    s_bv[wid] = bv;
    s_bi[wid] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < (nt + 31) / 32; ++w)
      if (s_bv[w] > bv || (s_bv[w] == bv && s_bi[w] < bi)) {
        bv = s_bv[w];
        bi = s_bi[w];
      }
    tok_out[0] = bi;
    if (tok_buf != nullptr && buf_len >= 0 && buf_len < a.S) tok_buf[buf_len] = bi;
  }
}

static inline int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The sampling settings of a whole-step argument struct (K1Args, K2Args).
template <class Args>
static inline SampleParams sample_params_of(const Args* a) {
  SampleParams s;
  s.V = a->V;
  s.NP = next_pow2(a->V);
  s.S = a->S;
  s.n_suppressed = a->n_suppressed;
  for (int i = 0; i < DEC_MAX_SUPPRESSED; ++i) s.suppressed[i] = a->suppressed[i];
  s.use_prev = a->use_prev;
  s.rep_penalty = a->rep_penalty;
  s.top_p = a->top_p;
  s.inv_temperature = a->inv_temperature;
  s.top_k = a->top_k;
  return s;
}

static inline size_t sample_smem_bytes(int V, int NP) {
  return sizeof(float) * (size_t)V + sizeof(float) * (size_t)NP + sizeof(int) * (size_t)NP +
         sizeof(int) * (size_t)V + sizeof(float) * SAMPLE_THREADS;
}
