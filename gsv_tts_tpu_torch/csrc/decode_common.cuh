// Device code shared by the decode kernels (K1 whole B=1 step, K2 whole
// batched step, K3 flash decode attention): warp/block reductions, the
// split-KV single-query attention (partial + combine), row-wise LayerNorm
// and the sampling chain of one logits row.  Each .cu that includes this is
// built into its own library, so everything here is static.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define DEC_NEG (-1e30f)
#define DEC_MAX_SUPPRESSED 8

constexpr int GEMV_WARPS = 8;        // output rows per GEMV block
constexpr int ATTN_THREADS = 128;    // 4 warps per (head, split) block
constexpr int ATTN_ROWS = 64;        // cache rows per split
constexpr int SAMPLE_THREADS = 1024;
constexpr int LN_THREADS = 256;

// error bits a kernel may set in its ``err`` word
constexpr int ERR_LAST_TOK = 1;  // last_tok outside [0, V)
constexpr int ERR_KV_LEN = 2;    // kv_len outside [0, S)
constexpr int ERR_PE_IDX = 4;    // positional index outside [0, P)

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
// Single-query attention, split over the cache (flash-decoding).  One block
// (ATTN_THREADS threads) handles one (slot, head, split): rows
// [64 split, 64 split + 64) of the n_cache cache rows followed, when kn/vn
// are given, by the token's own K/V in float32 (row n_cache).  It writes the
// split's partial (max, sum, unnormalised output [Dh]) to ``out``.  A row is
// read by LPR = Dh/8 lanes, 16 bytes each, so a warp covers 32/LPR rows per
// step; every (warp, row slot) keeps its own online softmax, merged in
// shared memory at the end.  Rows at or past n_cache are never read.
//   qr       this lane's 8 query values: dims (lane % LPR) * 8 ... + 7
//   kc, vc   the slot's cache rows of this layer, offset to this head
// ---------------------------------------------------------------------------
template <int LPR>
static __device__ __forceinline__ void attn_split_partial(
    const float (&qr)[8], const float* __restrict__ kn, const float* __restrict__ vn,
    const bf16* __restrict__ kc, const bf16* __restrict__ vc, int row_stride, int n_cache,
    int split, float scale, float* __restrict__ out) {
  constexpr int Dh = LPR * 8;
  constexpr int RPW = 32 / LPR;                      // rows per warp step
  constexpr int SLOTS = (ATTN_THREADS / 32) * RPW;
  __shared__ float s_m[SLOTS], s_l[SLOTS];
  __shared__ float s_acc[SLOTS][Dh];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp * RPW + lane / LPR;
  const int d0 = (lane % LPR) * 8;
  const int n_total = n_cache + (kn != nullptr ? 1 : 0);

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int s_end = min((split + 1) * ATTN_ROWS, n_total);
  for (int s0 = split * ATTN_ROWS + warp * RPW; s0 < s_end; s0 += (ATTN_THREADS / 32) * RPW) {
    const int s = s0 + lane / LPR;
    float kf[8], vf[8];
    if (s < n_cache) {
      const uint4 kr = *reinterpret_cast<const uint4*>(kc + (size_t)s * row_stride + d0);
      const uint4 vr = *reinterpret_cast<const uint4*>(vc + (size_t)s * row_stride + d0);
      bf16x8_to_float(kr, kf);
      bf16x8_to_float(vr, vf);
    } else {  // the token itself (s == n_cache), or past this split's end
      const bool own = kn != nullptr && s == n_cache;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kf[j] = own ? kn[d0 + j] : 0.f;
        vf[j] = own ? vn[d0 + j] : 0.f;
      }
    }
    float part_dot = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) part_dot += qr[j] * kf[j];
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) part_dot += __shfl_xor_sync(0xffffffffu, part_dot, o);
    if (s < s_end) {
      const float score = part_dot * scale;
      const float m_new = fmaxf(m, score);
      const float corr = expf(m - m_new);
      const float p = expf(score - m_new);
      l = l * corr + p;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = acc[j] * corr + p * vf[j];
      m = m_new;
    }
  }
  if (lane % LPR == 0) {
    s_m[slot] = m;
    s_l[slot] = l;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) s_acc[slot][d0 + j] = acc[j];
  __syncthreads();
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float mx = -INFINITY;
    for (int t = 0; t < SLOTS; ++t) mx = fmaxf(mx, s_m[t]);
    float lsum = 0.f, a = 0.f;
    for (int t = 0; t < SLOTS; ++t) {
      if (s_l[t] > 0.f) {
        const float c = expf(s_m[t] - mx);
        lsum += s_l[t] * c;
        a += s_acc[t][d] * c;
      }
    }
    out[2 + d] = a;
    if (d == 0) {
      out[0] = mx;
      out[1] = lsum;
    }
  }
}

// Merge ``nsplit`` partials (each Dh + 2 floats, at ``part``) into output
// dimension d of one (slot, head).
static __device__ __forceinline__ float attn_split_combine(const float* __restrict__ part,
                                                           int nsplit, int Dh, int d) {
  float mx = -INFINITY;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, part[(size_t)i * (Dh + 2)]);
  float lsum = 0.f, a = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const float* pi = part + (size_t)i * (Dh + 2);
    const float c = expf(pi[0] - mx);
    lsum += pi[1] * c;
    a += pi[2 + d] * c;
  }
  return a / lsum;
}

// ---------------------------------------------------------------------------
// out[r] = LayerNorm(in[r]) * g + b over D, float32, one block per row r
// (in place allowed: every thread reads and writes only its own elements).
// ---------------------------------------------------------------------------
static __global__ void __launch_bounds__(LN_THREADS)
layernorm_rows(const float* in, const float* __restrict__ g, const float* __restrict__ b,
               float* out, int D, float eps) {
  __shared__ float red[32];
  in += (size_t)blockIdx.x * D;
  out += (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) s += in[i];
  const float mean = block_sum(s, red) / D;
  float q = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = in[i] - mean;
    q += d * d;
  }
  const float var = block_sum(q, red) / D;
  const float inv = 1.f / sqrtf(var + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    out[i] = (in[i] - mean) * inv * g[i] + b[i];
}

// ---------------------------------------------------------------------------
// Sampling of one logits row by one block of SAMPLE_THREADS threads:
// suppression -> repetition penalty -> top-p on the pre-temperature row ->
// temperature -> top-k pivot -> argmax(row + g).  Top-p and top-k share one
// bitonic sort in shared memory (value descending, ties to the lowest id --
// the TPU kernels peel maxima with ties to the lowest lane).  The filtered
// row overwrites ``row``; the token goes to tok_out[0] and is appended to
// tok_buf[buf_len] (tok_buf is this row's S entries).  Dynamic shared
// memory: sample_smem_bytes(V, NP).
// ---------------------------------------------------------------------------
static __device__ __forceinline__ bool sample_before(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
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
  if (need_top_p || need_top_k) {
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

    if (need_top_p) {
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
  }

  for (int i = tid; i < V; i += nt) r[i] = r[i] * a.inv_temperature;
  __syncthreads();
  if (need_top_k) {
    // the k-th largest of the filtered row: kept entries are a prefix of
    // the sorted order, everything past it is -1e30; scaling by
    // 1/temperature is monotone, so the scaled pivot is the scaled value
    const float pivot = (k - 1 < n_keep ? key[k - 1] : DEC_NEG) * a.inv_temperature;
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

static inline size_t sample_smem_bytes(int V, int NP) {
  return sizeof(float) * (size_t)V + sizeof(float) * (size_t)NP + sizeof(int) * (size_t)NP +
         sizeof(int) * (size_t)V + sizeof(float) * SAMPLE_THREADS;
}
