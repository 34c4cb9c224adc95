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
// Single-query attention, split over the cache (flash-decoding).  A group of
// ATTN_THREADS threads handles one (slot, head, split): rows
// [64 split, 64 split + 64) of the n_cache cache rows followed, when has_own
// is set, by the token's own K/V in float32 (row n_cache).  It writes the
// split's partial (max, sum, unnormalised output [Dh]) to ``out``.  A row is
// read by LPR = Dh/8 lanes, 16 bytes each, so a warp covers 32/LPR rows per
// step; every (warp, row slot) keeps its own online softmax, merged in
// shared memory at the end.  Rows at or past n_cache are never read.
//   qr          this lane's 8 query values: dims (lane % LPR) * 8 ... + 7
//   kown, vown  the same 8 dims of the token's own K/V (read when has_own)
//   kc, vc      the slot's cache rows of this layer, offset to this head
//   s_m, s_l    [ATTN_SLOTS<LPR>] floats of shared memory each, s_acc
//               [ATTN_SLOTS<LPR> * Dh] = ATTN_ACC_FLOATS floats
//   tid         the thread's index in the group, sync() the group's barrier
// ---------------------------------------------------------------------------
constexpr int ATTN_ACC_FLOATS = ATTN_THREADS * 8;  // every lane's 8 outputs
constexpr int ATTN_MAX_SLOTS = ATTN_THREADS;       // Dh = 8: one row per lane

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// The walk: rows [s_begin, s_end) of the n_cache cache rows and, when has_own
// is set, the token's own row n_cache, by a group of NT threads.  Every
// (warp, row slot) -- the LPR lanes that share lane / LPR -- leaves the
// running maximum m, the sum l and its 8 unnormalised outputs acc of the
// rows it met (m = -inf, l = 0 where it met none).  The group walks STEP
// rows at a time; the loads of BATCH steps are issued together, so that it
// waits for device memory once per BATCH steps.
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

template <int LPR, class Sync>
static __device__ __forceinline__ void attn_split_partial_at(
    const float (&qr)[8], const float (&kown)[8], const float (&vown)[8], bool has_own,
    const bf16* __restrict__ kc, const bf16* __restrict__ vc, int row_stride, int n_cache,
    int split, float scale, float* out, float* s_m, float* s_l, float* s_acc, int tid,
    Sync sync) {
  constexpr int Dh = LPR * 8;
  constexpr int RPW = 32 / LPR;
  constexpr int SLOTS = (ATTN_THREADS / 32) * RPW;
  const int lane = tid & 31, warp = tid >> 5;
  const int slot = warp * RPW + lane / LPR;
  const int d0 = (lane % LPR) * 8;
  const int n_total = n_cache + (has_own ? 1 : 0);
  float acc[8], m, l;
  attn_walk<LPR, ATTN_THREADS>(qr, kown, vown, has_own, kc, vc, row_stride, n_cache,
                               split * ATTN_ROWS, min((split + 1) * ATTN_ROWS, n_total), scale,
                               tid, m, l, acc);
  if (lane % LPR == 0) {
    s_m[slot] = m;
    s_l[slot] = l;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) s_acc[slot * Dh + d0 + j] = acc[j];
  sync();
  for (int d = tid; d < Dh; d += ATTN_THREADS) {
    float mx = -INFINITY;
    for (int t = 0; t < SLOTS; ++t) mx = fmaxf(mx, s_m[t]);
    float lsum = 0.f, a = 0.f;
    for (int t = 0; t < SLOTS; ++t) {
      if (s_l[t] > 0.f) {
        const float c = expf(s_m[t] - mx);
        lsum += s_l[t] * c;
        a += s_acc[t * Dh + d] * c;
      }
    }
    out[2 + d] = a;
    if (d == 0) {
      out[0] = mx;
      out[1] = lsum;
    }
  }
}

// The same for a block of ATTN_THREADS threads of its own (one launch's
// block per (slot, head, split)); the token's K/V at kn / vn, or nullptr.
template <int LPR>
static __device__ __forceinline__ void attn_split_partial(
    const float (&qr)[8], const float* __restrict__ kn, const float* __restrict__ vn,
    const bf16* __restrict__ kc, const bf16* __restrict__ vc, int row_stride, int n_cache,
    int split, float scale, float* __restrict__ out) {
  __shared__ float s_m[ATTN_MAX_SLOTS], s_l[ATTN_MAX_SLOTS];
  __shared__ float s_acc[ATTN_ACC_FLOATS];
  const int d0 = (threadIdx.x & 31) % LPR * 8;
  float kown[8], vown[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    kown[j] = kn != nullptr ? kn[d0 + j] : 0.f;
    vown[j] = kn != nullptr ? vn[d0 + j] : 0.f;
  }
  attn_split_partial_at<LPR>(qr, kown, vown, kn != nullptr, kc, vc, row_stride, n_cache, split,
                             scale, out, s_m, s_l, s_acc, threadIdx.x, BlockSync());
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
// One post-norm transformer layer for a wave of NB <= ROWS_MAX_B rows, each
// with its own cache slot and length: what K1 (one row) and K2 run L times
// between their embedding and their head, K5 L times at one row, K6 once.
// A source that wants it defines DEC_WITH_ROWS before including this header
// (the others would only compile kernels they never launch).
// ---------------------------------------------------------------------------
#ifdef DEC_WITH_ROWS
constexpr int ROWS_MAX_B = 8;  // row accumulators a GEMV warp keeps

// float32 workspace of a wave (row-major, ROWS_MAX_B rows each) and the
// error word (ERR_* bits)
struct RowsWork {
  float* x;     // [B, D]   the layer's input and output
  float* h;     // [B, D]
  float* qkv;   // [B, 3D]
  float* attn;  // [B, D]
  float* mlp;   // [B, M]
  float* part;  // [B, H, ceil(S / 64), Dh + 2] attention partials
  int* err;     // [1]
};

// y[b, n] = (res[b, n] +) sum_k bf16(x[b, k]) * W[n, k] (+ bias[n]) (relu)
// for all NB rows b at once, float32.  One warp per output row n: each lane
// loads its 16 bytes (8 bf16) of W[n] once and feeds NB accumulators from
// the NB activation rows in shared memory (bf16, NB * K * 2 bytes).
// Requires K % 8 == 0 and 16-byte aligned weight rows and activations
// (checked by the caller).
template <int NB>
static __global__ void __launch_bounds__(GEMV_WARPS * 32)
rows_gemv(const bf16* __restrict__ W, const bf16* __restrict__ bias,
          const float* __restrict__ x, const float* __restrict__ res,
          float* __restrict__ y, int N, int K, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [NB, K]
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + (threadIdx.x >> 5);
  const bf16* w = W + (size_t)min(n, N - 1) * K;
  // the lane's first 16 bytes of the weight row are requested before the
  // activations are staged, so the two waits overlap
  uint4 wraw = make_uint4(0u, 0u, 0u, 0u);
  if (lane * 8 < K) wraw = __ldg(reinterpret_cast<const uint4*>(w + lane * 8));
  const float4* x4 = reinterpret_cast<const float4*>(x);
  __nv_bfloat162* xs2 = reinterpret_cast<__nv_bfloat162*>(xs);
  for (int i = threadIdx.x; i < NB * K / 4; i += blockDim.x) {
    const float4 v = x4[i];
    xs2[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    xs2[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
  __syncthreads();
  if (n >= N) return;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    float wf[8];
    bf16x8_to_float(wraw, wf);
    if (k + 32 * 8 < K) wraw = __ldg(reinterpret_cast<const uint4*>(w + k + 32 * 8));
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float xf[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(xs + (size_t)b * K + k), xf);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[b] = fmaf(wf[j], xf[j], acc[b]);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = warp_sum(acc[b]);
  if (lane == 0) {
    const float bv = bias ? __bfloat162float(bias[n]) : 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float v = acc[b];
      if (res) v = res[(size_t)b * N + n] + v;
      if (bias) v += bv;
      if (relu) v = fmaxf(v, 0.f);
      y[(size_t)b * N + n] = v;
    }
  }
}

// Per-slot single-query attention: block (head h, split j, slot b) covers
// rows [64 j, 64 j + 64) of [0, kv_len[b]] -- cache rows below kv_len[b]
// plus the token itself, whose K/V enter in float32 from qkv[b].  Split 0
// appends the slot's K/V row at kv_len[b] (never read here, so no race).
// Blocks whose split starts past kv_len[b] exit.  kc/vc: one layer's
// [B, S, D] cache.
template <int LPR>
static __global__ void __launch_bounds__(ATTN_THREADS)
rows_attn_partial(const float* __restrict__ qkv, bf16* __restrict__ kc, bf16* __restrict__ vc,
                  const int* __restrict__ kv_len, int S, int D, float scale,
                  float* __restrict__ part, int nsplit_max, int* __restrict__ err) {
  constexpr int Dh = LPR * 8;
  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z, H = gridDim.x;
  const int kv = kv_len[b];
  if (kv < 0 || kv >= S) {  // uniform over the block
    if (threadIdx.x == 0 && h == 0 && split == 0) atomicOr(err, ERR_KV_LEN);
    return;
  }
  if (split * ATTN_ROWS > kv) return;
  const size_t hoff = (size_t)h * Dh;
  const float* q = qkv + (size_t)b * 3 * D + hoff;
  const float* kn = q + D;
  const float* vn = q + 2 * D;
  bf16* kcb = kc + (size_t)b * S * D + hoff;
  bf16* vcb = vc + (size_t)b * S * D + hoff;
  if (split == 0) {
    for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
      kcb[(size_t)kv * D + d] = __float2bfloat16(kn[d]);
      vcb[(size_t)kv * D + d] = __float2bfloat16(vn[d]);
    }
  }
  const int d0 = (threadIdx.x & 31) % LPR * 8;
  float qr[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qr[j] = q[d0 + j];
  attn_split_partial<LPR>(qr, kn, vn, kcb, vcb, D, kv, split, scale,
                          part + (((size_t)b * H + h) * nsplit_max + split) * (Dh + 2));
}

// Merge the partials of (head blockIdx.x, slot blockIdx.y) into
// out[b, h*Dh : (h+1)*Dh]; a slot with a bad kv_len gets NaN.
static __global__ void rows_attn_combine(const float* __restrict__ part,
                                         const int* __restrict__ kv_len, int S, int nsplit_max,
                                         int Dh, float* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int kv = kv_len[b];
  const bool ok = kv >= 0 && kv < S;
  const int nsplit = ok ? kv / ATTN_ROWS + 1 : 0;
  const float* p = part + ((size_t)b * H + h) * nsplit_max * (Dh + 2);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x)
    out[((size_t)b * H + h) * Dh + d] = ok ? attn_split_combine(p, nsplit, Dh, d) : nanf("");
}

template <int NB>
static int launch_rows_gemv_nb(const bf16* W, const bf16* bias, const float* x, const float* res,
                               float* y, int N, int K, int relu, cudaStream_t st) {
  const int blocks = (N + GEMV_WARPS - 1) / GEMV_WARPS;
  rows_gemv<NB><<<blocks, GEMV_WARPS * 32, sizeof(bf16) * NB * K, st>>>(W, bias, x, res, y, N, K,
                                                                        relu);
  DEC_CHECK();
  return 0;
}

static int launch_rows_gemv(int B, const bf16* W, const bf16* bias, const float* x,
                            const float* res, float* y, int N, int K, int relu,
                            cudaStream_t st) {
  switch (B) {
    case 1: return launch_rows_gemv_nb<1>(W, bias, x, res, y, N, K, relu, st);
    case 2: return launch_rows_gemv_nb<2>(W, bias, x, res, y, N, K, relu, st);
    case 3: return launch_rows_gemv_nb<3>(W, bias, x, res, y, N, K, relu, st);
    case 4: return launch_rows_gemv_nb<4>(W, bias, x, res, y, N, K, relu, st);
    case 5: return launch_rows_gemv_nb<5>(W, bias, x, res, y, N, K, relu, st);
    case 6: return launch_rows_gemv_nb<6>(W, bias, x, res, y, N, K, relu, st);
    case 7: return launch_rows_gemv_nb<7>(W, bias, x, res, y, N, K, relu, st);
    case 8: return launch_rows_gemv_nb<8>(W, bias, x, res, y, N, K, relu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

static int launch_rows_attention(int B, int D, int H, int S, float scale, const float* qkv,
                                 bf16* kc, bf16* vc, const int* kv_len, float* part, float* out,
                                 int* err, cudaStream_t st) {
  const int Dh = D / H;
  const int nsplit_max = (S + ATTN_ROWS - 1) / ATTN_ROWS;
  const dim3 grid(H, nsplit_max, B);
#define ROWS_ATTN(LPR)                                                                    \
  rows_attn_partial<LPR><<<grid, ATTN_THREADS, 0, st>>>(qkv, kc, vc, kv_len, S, D, scale, \
                                                        part, nsplit_max, err)
  switch (Dh) {
    case 8: ROWS_ATTN(1); break;
    case 16: ROWS_ATTN(2); break;
    case 32: ROWS_ATTN(4); break;
    case 64: ROWS_ATTN(8); break;
    case 128: ROWS_ATTN(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ROWS_ATTN
  DEC_CHECK();
  rows_attn_combine<<<dim3(H, B), 128, 0, st>>>(part, kv_len, S, nsplit_max, Dh, out);
  DEC_CHECK();
  return 0;
}

// The layer: ws.x [B, D] -> ws.x, through qkv, the attention over the slot's
// cache rows below kv_len[b] plus the token itself (its K/V row appended at
// kv_len[b] of kc/vc, this layer's [B, S, D] cache), out-proj + residual +
// LayerNorm, MLP(ReLU) + residual + LayerNorm.  8 launches.
static int decode_layer_rows(int B, int D, int H, int M, int S, float scale,
                             const LayerWeights& w, bf16* kc, bf16* vc, const int* kv_len,
                             const RowsWork& ws, cudaStream_t st) {
  int rc;
  if (B < 1 || B > ROWS_MAX_B) return (int)cudaErrorInvalidValue;
  if ((rc = launch_rows_gemv(B, w.qkv_w, w.qkv_b, ws.x, nullptr, ws.qkv, 3 * D, D, 0, st)))
    return rc;
  if ((rc = launch_rows_attention(B, D, H, S, scale, ws.qkv, kc, vc, kv_len, ws.part, ws.attn,
                                  ws.err, st)))
    return rc;
  if ((rc = launch_rows_gemv(B, w.out_w, w.out_b, ws.attn, ws.x, ws.h, D, D, 0, st))) return rc;
  layernorm_rows<<<B, LN_THREADS, 0, st>>>(ws.h, w.ln1_g, w.ln1_b, ws.h, D, 1e-5f);
  DEC_CHECK();
  if ((rc = launch_rows_gemv(B, w.mlp1_w, w.mlp1_b, ws.h, nullptr, ws.mlp, M, D, 1, st)))
    return rc;
  if ((rc = launch_rows_gemv(B, w.mlp2_w, w.mlp2_b, ws.mlp, ws.h, ws.x, D, M, 0, st))) return rc;
  layernorm_rows<<<B, LN_THREADS, 0, st>>>(ws.x, w.ln2_g, w.ln2_b, ws.x, D, 1e-5f);
  DEC_CHECK();
  return 0;
}

// A given hidden wave in bf16 or float32 -> the float32 workspace, and back
// (K5 and K6 take and return tensors of the caller's type).
static __device__ __forceinline__ float dec_to_float(float v) { return v; }
static __device__ __forceinline__ float dec_to_float(bf16 v) { return __bfloat162float(v); }
static __device__ __forceinline__ void dec_store(float* p, float v) { *p = v; }
static __device__ __forceinline__ void dec_store(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename TI, typename TO>
static __global__ void rows_convert(const TI* __restrict__ in, TO* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    dec_store(out + i, dec_to_float(in[i]));
}

// in [n] of bf16 (in_f32 = 0) or float32 -> float32 out
static int launch_rows_load(const void* in, int in_f32, float* out, int n, cudaStream_t st) {
  const int blocks = (n + 255) / 256;
  if (in_f32)
    rows_convert<float, float><<<blocks, 256, 0, st>>>((const float*)in, out, n);
  else
    rows_convert<bf16, float><<<blocks, 256, 0, st>>>((const bf16*)in, out, n);
  DEC_CHECK();
  return 0;
}

static int launch_rows_store(const float* in, void* out, int out_f32, int n, cudaStream_t st) {
  const int blocks = (n + 255) / 256;
  if (out_f32)
    rows_convert<float, float><<<blocks, 256, 0, st>>>(in, (float*)out, n);
  else
    rows_convert<float, bf16><<<blocks, 256, 0, st>>>(in, (bf16*)out, n);
  DEC_CHECK();
  return 0;
}
#endif  // DEC_WITH_ROWS

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
