// K4: prefill self-attention under the t2s hybrid prompt mask on Hopper
// (sm_90a).
//
// Replaces the TPU kernel gsv_tts_tpu/ops/flash_prefill.py:_kernel (wrapper
// flash_prefill_attention).  Row r of batch entry b attends column c iff
//     (c < xl  or  (r >= xl and c <= r))  and  c < xyl
// with xl = x_lens[b], xyl = xy_lens[b]: the phoneme block is bidirectional
// and never sees audio, audio rows are causal over everything valid, pad
// columns are dead, pad rows (r >= xyl) attend every valid column.  For
// every row the attended columns are a prefix [0, n_r):
//     n_r = min(xl, xyl) for r < xl,  r + 1 for xl <= r < xyl,  xyl for pad rows.
//
// What bounds it on the card: at B=1, T=512, D=512 the call moves 4*T*D*2 =
// 2 MB and does ~0.3 GFLOP -- under a microsecond either way -- so the
// bound is far below a launch.  What matters is not to materialise the
// [B, H, T, T] float32 scores the plain version writes and reads again
// (16 MB per layer at T=512).  The TPU kernel keeps a whole (b, h)'s K and V
// in VMEM per program and scores all T columns; K and V of one (b, h) at
// T=1024 are 64 KB each, over what a block gets without opting in, and more
// than half the columns of a row are dead.  So this design walks K and V in
// tiles through shared memory and stops each row at its own n_r:
//   * grid (b*h, query tile of 32 rows); 8 warps, each owning 4 query rows;
//   * K/V tiles of KT rows staged by the whole block with 16-byte loads
//     (K rows padded by one bank so that lane j reads row j without
//     conflicts), zero-filled past the block's largest n_r;
//   * scores: lane j takes key j of the tile (one K read feeds the warp's 4
//     rows, the query rows sit pre-scaled in shared memory as float32 and
//     are read four values at a time);
//   * an online softmax per row in float32 registers, one max and one sum
//     reduction per 32 keys;
//   * P.V: lane d owns output element d (and d+32, ... for wider heads); one
//     V read per key feeds the warp's 4 rows, whose probabilities come round
//     by shuffle, only for keys below the warp's largest n_r.
// q, k and v are read through their strides (they arrive as views of the
// [B, T, 3D] qkv product), the lengths from the device arrays.
//
// The TPU kernel takes one softmax over the row and rounds p/l to the value
// type before P.V; the online softmax here keeps p unnormalised in float32
// and divides at the end.  In float32 the two agree to ~1e-6; in bf16 the
// twin's rounding of the probabilities (2^-9 relative) is the difference.
//
// Lengths outside 0 <= xl, 1 <= xyl <= T set K4_ERR_LENS in ``err`` and give
// that batch entry NaN; nothing is clamped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

constexpr int K4_WARPS = 8;
constexpr int K4_RPW = 4;                   // query rows per warp
constexpr int K4_QT = K4_WARPS * K4_RPW;    // query rows per block
constexpr int K4_ERR_LENS = 8;  // its bit in the t2s kernels' error word (ERR_* of decode_common.cuh)

struct K4Args {
  const void* q;  // [B, T, H, Dh] through the strides below (last stride 1)
  const void* k;
  const void* v;
  const int* x_lens;   // [B]
  const int* xy_lens;  // [B]
  void* out;           // [B, T, H * Dh] contiguous
  int* err;            // [1]
  int B, T, H, Dh;
  int is_f32;          // q, k, v, out are float32 (else bf16)
  long long q_sb, q_st, q_sh;  // strides in elements: batch, row, head
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
};

static __device__ __forceinline__ float k4_to_float(float v) { return v; }
static __device__ __forceinline__ float k4_to_float(bf16 v) { return __bfloat162float(v); }
static __device__ __forceinline__ void k4_store(float* p, float v) { *p = v; }
static __device__ __forceinline__ void k4_store(bf16* p, float v) { *p = __float2bfloat16(v); }

static __device__ __forceinline__ float k4_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ float k4_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// four consecutive shared-memory values as float32 (``p`` 4-byte aligned for
// bf16, as the padded K rows are)
static __device__ __forceinline__ void k4_load4(const float* p, float (&f)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = p[j];
}
static __device__ __forceinline__ void k4_load4(const bf16* p, float (&f)[4]) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]), b = __bfloat1622float2(p2[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// columns row r attends: [0, n_r)
static __device__ __forceinline__ int k4_row_limit(int r, int xl, int xyl) {
  if (r < xl) return min(xl, xyl);
  return r < xyl ? r + 1 : xyl;
}

// Rows [c0, c0 + KT) of one (b, h)'s K or V (row stride ``st`` elements) into
// shared memory with row stride DS, 16 bytes per thread and step; rows at or
// past ``n`` are zero-filled and never read from device memory.
template <typename T, int DH, int KT, int DS>
static __device__ __forceinline__ void k4_stage(const T* __restrict__ src, long long st, int c0,
                                                int n, T* __restrict__ dst) {
  constexpr int VN = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = DH / VN;        // loads per row
  for (int i = threadIdx.x; i < KT * VPR; i += blockDim.x) {
    const int j = i / VPR, dv = (i % VPR) * VN;
    const int c = c0 + j;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (c < n) raw = *reinterpret_cast<const uint4*>(src + (long long)c * st + dv);
    uint32_t* d32 = reinterpret_cast<uint32_t*>(dst + j * DS + dv);
    d32[0] = raw.x;
    d32[1] = raw.y;
    d32[2] = raw.z;
    d32[3] = raw.w;
  }
}

template <typename T, int DH, int KT>
__global__ void __launch_bounds__(K4_WARPS * 32)
k4_prefill(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ x_lens, const int* __restrict__ xy_lens, T* __restrict__ out,
           int* __restrict__ err, int Tn, int H, long long q_sb, long long q_st, long long q_sh,
           long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
           long long v_sh, float scale) {
  constexpr int KS = DH + (sizeof(T) == 2 ? 2 : 1);  // K row stride: one bank of padding
  constexpr int EPL = (DH + 31) / 32;                // output elements per lane
  __shared__ __align__(16) unsigned char s_k_raw[KT * KS * sizeof(T)];
  __shared__ __align__(16) unsigned char s_v_raw[KT * DH * sizeof(T)];
  T* s_k = reinterpret_cast<T*>(s_k_raw);
  T* s_v = reinterpret_cast<T*>(s_v_raw);
  __shared__ __align__(16) float s_q[K4_QT * DH];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int r0 = blockIdx.y * K4_QT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xl = x_lens[b], xyl = xy_lens[b];
  T* ob = out + ((size_t)b * Tn * H + h) * DH;  // row r at ob + r * H * DH

  if (xl < 0 || xyl < 1 || xyl > Tn) {  // uniform over the block
    if (threadIdx.x == 0 && blockIdx.y == 0 && h == 0) atomicOr(err, K4_ERR_LENS);
    for (int i = threadIdx.x; i < K4_QT * DH; i += blockDim.x) {
      const int r = r0 + i / DH;
      if (r < Tn) k4_store(ob + (size_t)r * H * DH + i % DH, nanf(""));
    }
    return;
  }

  // the block's query rows, pre-scaled, as float32
  const T* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  for (int i = threadIdx.x; i < K4_QT * DH; i += blockDim.x) {
    const int r = r0 + i / DH;
    s_q[i] = r < Tn ? k4_to_float(qb[(long long)r * q_st + i % DH]) * scale : 0.f;
  }

  int lim[K4_RPW];
  int wmax = 0;  // the warp's largest limit
#pragma unroll
  for (int i = 0; i < K4_RPW; ++i) {
    const int r = r0 + warp * K4_RPW + i;
    lim[i] = r < Tn ? k4_row_limit(r, xl, xyl) : 0;
    wmax = max(wmax, lim[i]);
  }
  int n_max = 0;  // the block's largest limit
  for (int i = 0; i < K4_QT; ++i)
    if (r0 + i < Tn) n_max = max(n_max, k4_row_limit(r0 + i, xl, xyl));

  float m[K4_RPW], l[K4_RPW], acc[K4_RPW][EPL];
#pragma unroll
  for (int i = 0; i < K4_RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }

  const T* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)h * v_sh;
  const float* qw = s_q + warp * K4_RPW * DH;
  for (int c0 = 0; c0 < n_max; c0 += KT) {
    __syncthreads();  // the previous tile is consumed (first pass: s_q is written)
    k4_stage<T, DH, KT, KS>(kb, k_st, c0, n_max, s_k);
    k4_stage<T, DH, KT, DH>(vb, v_st, c0, n_max, s_v);
    __syncthreads();
#pragma unroll
    for (int half = 0; half < KT / 32; ++half) {
      const int base = c0 + half * 32;
      if (base >= wmax) break;  // uniform over the warp
      // scores of key (base + lane) against the warp's rows: four K values
      // and four query values per shared-memory load
      float s[K4_RPW];
#pragma unroll
      for (int i = 0; i < K4_RPW; ++i) s[i] = 0.f;
      const T* kr = s_k + (half * 32 + lane) * KS;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        float kd[4];
        k4_load4(kr + d, kd);
#pragma unroll
        for (int i = 0; i < K4_RPW; ++i) {
          const float4 q4 = *reinterpret_cast<const float4*>(qw + i * DH + d);
          s[i] = fmaf(q4.x, kd[0], s[i]);
          s[i] = fmaf(q4.y, kd[1], s[i]);
          s[i] = fmaf(q4.z, kd[2], s[i]);
          s[i] = fmaf(q4.w, kd[3], s[i]);
        }
      }
      // the rows' online softmax; p[i] stays 0 for a key row i does not attend
      float p[K4_RPW];
#pragma unroll
      for (int i = 0; i < K4_RPW; ++i) {
        p[i] = 0.f;
        if (base >= lim[i]) continue;  // uniform over the warp
        const bool valid = base + lane < lim[i];
        const float sv = valid ? s[i] : -INFINITY;
        const float m_new = fmaxf(m[i], k4_warp_max(sv));  // finite: key ``base`` is valid
        const float corr = expf(m[i] - m_new);
        p[i] = valid ? expf(sv - m_new) : 0.f;
        l[i] = l[i] * corr + k4_warp_sum(p[i]);
        m[i] = m_new;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[i][e] *= corr;
      }
      // P.V: one V read per key and element feeds the warp's rows
      const int nk = min(32, wmax - base);
      const T* vr = s_v + half * 32 * DH;
      for (int jj = 0; jj < nk; ++jj) {
        float vd[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = lane + 32 * e;
          vd[e] = d < DH ? k4_to_float(vr[jj * DH + d]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < K4_RPW; ++i) {
          const float pj = __shfl_sync(0xffffffffu, p[i], jj);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(pj, vd[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < K4_RPW; ++i) {
    const int r = r0 + warp * K4_RPW + i;
    if (r >= Tn) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      if (d < DH) k4_store(ob + (size_t)r * H * DH + d, acc[i][e] * inv);
    }
  }
}

template <typename T, int DH, int KT>
static int k4_launch_dh(const K4Args* a, cudaStream_t st) {
  const dim3 grid(a->B * a->H, (a->T + K4_QT - 1) / K4_QT);
  k4_prefill<T, DH, KT><<<grid, K4_WARPS * 32, 0, st>>>(
      (const T*)a->q, (const T*)a->k, (const T*)a->v, a->x_lens, a->xy_lens, (T*)a->out, a->err,
      a->T, a->H, a->q_sb, a->q_st, a->q_sh, a->k_sb, a->k_st, a->k_sh, a->v_sb, a->v_st,
      a->v_sh, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T>
static int k4_launch(const K4Args* a, cudaStream_t st) {
  switch (a->Dh) {
    case 8: return k4_launch_dh<T, 8, 64>(a, st);
    case 16: return k4_launch_dh<T, 16, 64>(a, st);
    case 32: return k4_launch_dh<T, 32, 64>(a, st);
    case 64: return k4_launch_dh<T, 64, 64>(a, st);
    case 128:
      // float32 tiles of 128-wide heads do not fit the static shared memory
      if constexpr (sizeof(T) == 2) return k4_launch_dh<T, 128, 32>(a, st);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// The host entry point.  Returns the CUDA error of the launch (0 = accepted).
extern "C" int k4_flash_prefill(const K4Args* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a->B < 1 || a->T < 1 || a->H < 1) return (int)cudaErrorInvalidValue;
  return a->is_f32 ? k4_launch<float>(a, st) : k4_launch<bf16>(a, st);
}
