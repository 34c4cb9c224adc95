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
//     n_r = min(xl, xyl) for r < xl,  r + 1 for xl <= r < xyl,  xyl for pad rows,
// and n_r never decreases with r, so a run of rows stops at its last row's n_r.
//
// What bounds it on the card: at B=1, T=512, D=512 the call moves 4*T*D*2 =
// 2 MB and does ~0.3 GFLOP -- 0.63 us of bytes, 0.31 us of bf16 tensor-core
// work -- so the bound is below a launch.  What matters is not to materialise
// the [B, H, T, T] float32 scores the plain version writes and reads again
// (16 MB per layer at T=512), and to do the products on the tensor cores: on
// CUDA cores (the first design, below) the same call took 52 us, bound by
// the rate of its instructions.  Two bodies, picked by dtype alone:
//
// bf16: k4_prefill_tc, FlashAttention-2 shaped, on mma.sync m16n8k16 (bf16
// in, float32 accumulate):
//   * grid (query tile of 64 rows, b*h).  At B=1 and H=16 that is 16 x 3
//     blocks at T=160 and 16 x 8 = 128 at T=512: one block per SM, no tail
//     wave; heavier tiles (later rows attend more columns) are handed out
//     first;
//   * a block is 4 row groups (16 query rows a warp, the mma's M) times G key
//     groups (4 for heads up to 32 wide, 2 for 64, 1 for 128): each step
//     stages G * 32 keys and warp (g, r) takes the 32 from 32 g for its rows.
//     With one block per SM and a single warp per row group, every product,
//     exponent and shuffle of the walk waited on the one before it (12.7 us
//     at T=512 on an H100 80GB HBM3 at 700 W, against 52 on the CUDA cores);
//     the key groups put G warps on each scheduler and cut each warp's chain
//     of steps by G.  At the end the groups' (max, sum, outputs) meet in
//     shared memory in group order;
//   * K/V steps stream through a two-stage ring with cp.async, 16 bytes a
//     thread, the next step's copy in flight while the current one is
//     multiplied; one barrier a step both publishes it and frees the stage
//     the next copy refills.  Rows are padded by 16 bytes, so the 8 row
//     addresses of an ldmatrix hit 8 distinct bank quads.  Rows past the
//     block's largest n_r are zero-filled by the copy and never read from
//     device memory;
//   * Q stays in registers as A fragments for the whole walk, loaded once
//     through its strides; K's B fragments come by ldmatrix, V's by
//     ldmatrix.trans;
//   * the scores' accumulator fragment, scaled into log2 units, exponentiated
//     and packed to bf16, is P.V's A fragment: P never leaves registers (it is
//     rounded to bf16 before P.V as the TPU kernel rounds its probabilities
//     to the value type); the row max and sum stay in registers, reduced over
//     the quad of lanes that shares a row;
//   * a warp skips the slices and 16-key steps past its last row's n_r, and
//     masks only on slices that reach past its first row's n_r;
//   * head dims 16..128 take Dh/16 k-steps; Dh=8 pads the k-depth to 16 with
//     zero fragments in registers.
//
// float32: k4_prefill, the first design, on CUDA cores (TF32 would miss the
// float32 tolerance, and float32 is no dtype of a path on the card):
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
//
// q, k and v are read through their strides (they arrive as views of the
// [B, T, 3D] qkv product), the lengths from the device arrays.  The TPU
// kernel takes one softmax over the row and rounds p/l to the value type
// before P.V; both bodies run an online softmax and divide at the end.  In
// float32 the two agree to ~1e-6; in bf16 the roundings of the probabilities
// (2^-9 relative) are the difference.
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

// What a call's shapes and strides fix; the wrapper builds it once per key.
struct K4Shape {
  int B, T, H, Dh;
  int is_f32;                  // q, k, v, out are float32 (else bf16)
  long long q_sb, q_st, q_sh;  // strides in elements: batch, row, head (last stride 1)
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
};

struct K4Args {
  const void* q;  // [B, T, H, Dh] through the strides of ``s``
  const void* k;
  const void* v;
  const int* x_lens;   // [B]
  const int* xy_lens;  // [B]
  void* out;           // [B, T, H * Dh] contiguous
  int* err;            // [1]
  const K4Shape* s;
};

// ---------------------------------------------------------------------------
// The CUDA-core body (float32)
// ---------------------------------------------------------------------------
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

// four consecutive shared-memory values
static __device__ __forceinline__ void k4_load4(const float* p, float (&f)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = p[j];
}

// columns row r attends: [0, n_r)
static __device__ __forceinline__ int k4_row_limit(int r, int xl, int xyl) {
  if (r < xl) return min(xl, xyl);
  return r < xyl ? r + 1 : xyl;
}

// Rows [c0, c0 + KT) of one (b, h)'s K or V (row stride ``st`` elements) into
// shared memory with row stride DS, 16 bytes per thread and step; rows at or
// past ``n`` are zero-filled and never read from device memory.
template <int DH, int KT, int DS>
static __device__ __forceinline__ void k4_stage(const float* __restrict__ src, long long st, int c0,
                                                int n, float* __restrict__ dst) {
  constexpr int VN = 4;               // elements per 16-byte load
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

template <int DH, int KT>
__global__ void __launch_bounds__(K4_WARPS * 32)
k4_prefill(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const int* __restrict__ x_lens, const int* __restrict__ xy_lens, float* __restrict__ out,
           int* __restrict__ err, int Tn, int H, long long q_sb, long long q_st, long long q_sh,
           long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
           long long v_sh, float scale) {
  constexpr int KS = DH + 1;            // K row stride: one bank of padding
  constexpr int EPL = (DH + 31) / 32;   // output elements per lane
  __shared__ __align__(16) float s_k[KT * KS];
  __shared__ __align__(16) float s_v[KT * DH];
  __shared__ __align__(16) float s_q[K4_QT * DH];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int r0 = blockIdx.y * K4_QT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xl = x_lens[b], xyl = xy_lens[b];
  float* ob = out + ((size_t)b * Tn * H + h) * DH;  // row r at ob + r * H * DH

  if (xl < 0 || xyl < 1 || xyl > Tn) {  // uniform over the block
    if (threadIdx.x == 0 && blockIdx.y == 0 && h == 0) atomicOr(err, K4_ERR_LENS);
    for (int i = threadIdx.x; i < K4_QT * DH; i += blockDim.x) {
      const int r = r0 + i / DH;
      if (r < Tn) ob[(size_t)r * H * DH + i % DH] = nanf("");
    }
    return;
  }

  // the block's query rows, pre-scaled, as float32
  const float* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  for (int i = threadIdx.x; i < K4_QT * DH; i += blockDim.x) {
    const int r = r0 + i / DH;
    s_q[i] = r < Tn ? qb[(long long)r * q_st + i % DH] * scale : 0.f;
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

  const float* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const float* vb = v + (long long)b * v_sb + (long long)h * v_sh;
  const float* qw = s_q + warp * K4_RPW * DH;
  for (int c0 = 0; c0 < n_max; c0 += KT) {
    __syncthreads();  // the previous tile is consumed (first pass: s_q is written)
    k4_stage<DH, KT, KS>(kb, k_st, c0, n_max, s_k);
    k4_stage<DH, KT, DH>(vb, v_st, c0, n_max, s_v);
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
      const float* kr = s_k + (half * 32 + lane) * KS;
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
      const float* vr = s_v + half * 32 * DH;
      for (int jj = 0; jj < nk; ++jj) {
        float vd[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = lane + 32 * e;
          vd[e] = d < DH ? vr[jj * DH + d] : 0.f;
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
      if (d < DH) ob[(size_t)r * H * DH + d] = acc[i][e] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16)
// ---------------------------------------------------------------------------
constexpr int K4T_WARPS = 4;
constexpr int K4T_QT = 16 * K4T_WARPS;  // query rows per block
constexpr int K4T_STAGES = 2;           // K/V steps in the shared-memory ring

static __device__ __forceinline__ uint32_t k4_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from device memory into shared memory, asynchronously; ``bytes``
// 0 writes zeros and reads nothing.
static __device__ __forceinline__ void k4_cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(k4_smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
static __device__ __forceinline__ void k4_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
static __device__ __forceinline__ void k4_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

static __device__ __forceinline__ void k4_ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(k4_smem_addr(p)));
}
static __device__ __forceinline__ void k4_ldmatrix_x2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[2])
               : "r"(k4_smem_addr(p)));
  r[1] = r[3] = 0u;
}
static __device__ __forceinline__ void k4_ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(k4_smem_addr(p)));
}
static __device__ __forceinline__ void k4_ldmatrix_x2_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(k4_smem_addr(p)));
  r[2] = r[3] = 0u;
}

// c += a . b on one m16n8k16 tile: bf16 inputs, float32 accumulators
static __device__ __forceinline__ void k4_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ uint32_t k4_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two consecutive bf16 of device memory (4-byte aligned) as one register
static __device__ __forceinline__ uint32_t k4_ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [c0, c0 + NR) of one (b, h)'s K or V (row stride ``st`` elements) into
// shared memory with row stride RS, by cp.async from the NT threads of the
// block; rows at or past ``n`` are zero-filled and read nothing.
template <int DH, int NR, int RS, int NT>
static __device__ __forceinline__ void k4_stage_async(const bf16* __restrict__ src, long long st,
                                                      int c0, int n, bf16* dst) {
  constexpr int CPR = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < NR * CPR; i += NT) {
    const int j = i / CPR, ch = i % CPR;
    const int c = c0 + j;
    const bool live = c < n;
    k4_cp_async16(dst + j * RS + ch * 8, src + (live ? (long long)c * st : 0) + ch * 8,
                  live ? 16 : 0);
  }
}

// G key groups of 4 warps: warp (g, rg) owns query rows 16 rg .. 16 rg + 15 of
// the block and, of every step's G * KT staged keys, the KT keys from g * KT.
template <int DH, int KT, int G>
__global__ void __launch_bounds__(K4T_WARPS * 32 * G)
k4_prefill_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const int* __restrict__ x_lens, const int* __restrict__ xy_lens,
              bf16* __restrict__ out, int* __restrict__ err, int Tn, int H, long long q_sb,
              long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
              long long v_sb, long long v_st, long long v_sh, float scale_log2) {
  constexpr int NT = K4T_WARPS * 32 * G;   // threads of the block
  constexpr int DK = DH < 16 ? 16 : DH;    // k-depth of Q.K^T (Dh=8: zero-padded)
  constexpr int KSTEPS = DK / 16;
  constexpr int NO = DH / 8;               // output n-tiles of 8 dims
  constexpr int NS = KT / 8;               // score n-tiles of 8 keys
  constexpr int RS = DK + 8;               // shared row stride (elements): 16 bytes of padding
  constexpr int SK = G * KT;               // keys a step stages
  constexpr int TILE = SK * RS;            // elements of one staged K or V step
  // the ring: stage s holds its K rows at s_kv + 2s * TILE, its V rows after
  // them; after the walk the same memory takes the key groups' partials
  constexpr int RING_BYTES = 2 * K4T_STAGES * TILE * sizeof(bf16);
  constexpr int MERGE_BYTES = (G - 1) * K4T_QT * (DH + 2) * sizeof(float);
  __shared__ __align__(128) unsigned char s_raw[RING_BYTES > MERGE_BYTES ? RING_BYTES
                                                                        : MERGE_BYTES];
  bf16* const s_kv = reinterpret_cast<bf16*>(s_raw);

  const int rt = gridDim.x - 1 - blockIdx.x;  // query tile, heaviest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int r0 = rt * K4T_QT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % K4T_WARPS, g = warp / K4T_WARPS;  // row group, key group
  const int xl = x_lens[b], xyl = xy_lens[b];
  bf16* ob = out + ((size_t)b * Tn * H + h) * DH;  // row r at ob + r * H * DH

  if (xl < 0 || xyl < 1 || xyl > Tn) {  // uniform over the block
    if (threadIdx.x == 0 && rt == 0 && h == 0) atomicOr(err, K4_ERR_LENS);
    for (int i = threadIdx.x; i < K4T_QT * DH; i += NT) {
      const int r = r0 + i / DH;
      if (r < Tn) ob[(size_t)r * H * DH + i % DH] = __float2bfloat16(nanf(""));
    }
    return;
  }

  // n_r never decreases with r: the block's and the warp's largest limits are
  // their last rows', the warp's smallest its first row's
  const int n_max = k4_row_limit(min(r0 + K4T_QT, Tn) - 1, xl, xyl);
  const int wr0 = r0 + rg * 16;
  const bool w_live = wr0 < Tn;
  const int w_lo = w_live ? k4_row_limit(wr0, xl, xyl) : 0;
  const int w_hi = w_live ? k4_row_limit(min(wr0 + 16, Tn) - 1, xl, xyl) : 0;
  // this lane's two rows (the accumulator fragment's rows lane/4 and lane/4 + 8)
  const int ra = wr0 + (lane >> 2), rb = ra + 8;
  const int lim[2] = {k4_row_limit(ra, xl, xyl), k4_row_limit(rb, xl, xyl)};

  const bf16* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const bf16* vb = v + (long long)b * v_sb + (long long)h * v_sh;
  const int n_steps = (n_max + SK - 1) / SK;
  // step t goes to stage t % K4T_STAGES in commit group t (groups past the
  // last step are empty, so that the count stays uniform)
  auto stage = [&](int t) {
    if (t < n_steps) {
      bf16* dst = s_kv + 2 * (t % K4T_STAGES) * TILE;
      k4_stage_async<DH, SK, RS, NT>(kb, k_st, t * SK, n_max, dst);
      k4_stage_async<DH, SK, RS, NT>(vb, v_st, t * SK, n_max, dst + TILE);
    }
    k4_cp_commit();
  };
#pragma unroll
  for (int t = 0; t < K4T_STAGES - 1; ++t) stage(t);

  // the warp's 16 query rows as A fragments, for the whole walk
  uint32_t qf[KSTEPS][4];
  {
    const bf16* qb = q + (long long)b * q_sb + (long long)h * q_sh;
    const int col = (lane & 3) * 2;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const bf16* pa = qb + (long long)ra * q_st + ks * 16 + col;
      const bf16* pb = qb + (long long)rb * q_st + ks * 16 + col;
      qf[ks][0] = ra < Tn ? k4_ld2(pa) : 0u;
      qf[ks][1] = rb < Tn ? k4_ld2(pb) : 0u;
      qf[ks][2] = (DH >= 16 && ra < Tn) ? k4_ld2(pa + 8) : 0u;
      qf[ks][3] = (DH >= 16 && rb < Tn) ? k4_ld2(pb + 8) : 0u;
    }
  }

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // ldmatrix row addresses: lane i names row i % 8 of matrix i / 8
  const int lm_row = lane & 7, lm_mat = lane >> 3;
  for (int t = 0; t < n_steps; ++t) {
    k4_cp_wait<K4T_STAGES - 2>();  // this thread's copies of step t have landed
    // every thread's have; and every warp is done with step t - 1, whose
    // stage the copy of step t + K4T_STAGES - 1 now refills
    __syncthreads();
    stage(t + K4T_STAGES - 1);
    const int c0 = t * SK + g * KT;  // the warp's first key of the step
    if (c0 < w_hi) {                 // uniform over the warp
      // 16-key steps that hold a column some row of the warp attends
      const int n16 = min(KT / 16, (w_hi - c0 + 15) >> 4);
      const bf16* sk = s_kv + 2 * (t % K4T_STAGES) * TILE + g * KT * RS;
      const bf16* sv = sk + TILE;
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      // S = Q K^T: matrices (keys +0..7, dims +0..7), (+0..7, +8..15),
      // (+8..15, +0..7), (+8..15, +8..15) give b0, b1 of two key tiles
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        if (kk < n16) {
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks) {
            uint32_t bk[4];
            if constexpr (DH >= 16) {
              k4_ldmatrix_x4(bk, sk + (kk * 16 + (lm_mat >> 1) * 8 + lm_row) * RS + ks * 16 +
                                     (lm_mat & 1) * 8);
            } else {  // Dh=8: dims 8..15 are the zero fragments
              k4_ldmatrix_x2(bk, sk + (kk * 16 + ((lm_mat & 1) * 8) + lm_row) * RS);
            }
            k4_mma(s[2 * kk], qf[ks], bk[0], bk[1]);
            k4_mma(s[2 * kk + 1], qf[ks], bk[2], bk[3]);
          }
        }
      }
      // the online softmax in log2 units; columns at or past a row's n_r
      // (and the 16-key steps not computed, all past w_hi) are -inf
      const bool masked = c0 + KT > w_lo;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (masked && c0 + j * 8 + (lane & 3) * 2 + (e & 1) >= lim[e >> 1]) x = -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // a row of a key group past the first may have met no column it
        // attends yet: its max stays -inf, its probabilities 0
        corr[i] = m[i] == -INFINITY ? 0.f : exp2f(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mi = m[e >> 1];
          s[j][e] = mi == -INFINITY ? 0.f : exp2f(s[j][e] - mi);
          l[e >> 1] += s[j][e];
        }
      }
      // O += P V: the score tiles 2kk, 2kk+1 packed to bf16 are the A
      // fragment of key step kk; matrices (keys +0..7, dims +0..7),
      // (+8..15, +0..7), (+0..7, +8..15), (+8..15, +8..15) transposed give
      // b0, b1 of two output tiles
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        if (kk < n16) {
          const uint32_t pa[4] = {k4_pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  k4_pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  k4_pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  k4_pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const bf16* vrow = sv + (kk * 16 + (lm_mat & 1) * 8 + lm_row) * RS;
          if constexpr (NO >= 2) {
#pragma unroll
            for (int j = 0; j < NO; j += 2) {
              uint32_t bv[4];
              k4_ldmatrix_x4_trans(bv, vrow + j * 8 + (lm_mat >> 1) * 8);
              k4_mma(o[j], pa, bv[0], bv[1]);
              k4_mma(o[j + 1], pa, bv[2], bv[3]);
            }
          } else {
            uint32_t bv[4];
            k4_ldmatrix_x2_trans(bv, vrow);
            k4_mma(o[0], pa, bv[0], bv[1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int d = (lane & 3) * 2;
  if constexpr (G > 1) {
    // the key groups' partials meet in key-group order: groups 1.. leave
    // (max, sum, outputs) of their rows in shared memory, group 0 merges
    k4_cp_wait<0>();  // (only empty groups can be left, but the ring is reused)
    __syncthreads();  // every warp is done with the ring
    float* s_part = reinterpret_cast<float*>(s_raw);  // [G-1][64 rows][Dh + 2]
    const int la = rg * 16 + (lane >> 2), lb = la + 8;  // the rows within the block
    if (g > 0) {
      float* pa = s_part + ((g - 1) * K4T_QT + la) * (DH + 2);
      float* pb = s_part + ((g - 1) * K4T_QT + lb) * (DH + 2);
      if ((lane & 3) == 0) {
        pa[0] = m[0];
        pa[1] = l[0];
        pb[0] = m[1];
        pb[1] = l[1];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        pa[2 + j * 8 + d] = o[j][0];
        pa[3 + j * 8 + d] = o[j][1];
        pb[2 + j * 8 + d] = o[j][2];
        pb[3 + j * 8 + d] = o[j][3];
      }
    }
    __syncthreads();
    if (g > 0) return;
#pragma unroll
    for (int gg = 1; gg < G; ++gg) {
      const float* pa = s_part + ((gg - 1) * K4T_QT + la) * (DH + 2);
      const float* pb = s_part + ((gg - 1) * K4T_QT + lb) * (DH + 2);
      float c[2], cg[2];
      const float mg[2] = {pa[0], pb[0]}, lg[2] = {pa[1], pb[1]};
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // group 0 met column 0 of every row: m[i] is finite
        const float mx = fmaxf(m[i], mg[i]);
        c[i] = exp2f(m[i] - mx);
        cg[i] = mg[i] == -INFINITY ? 0.f : exp2f(mg[i] - mx);
        l[i] = l[i] * c[i] + lg[i] * cg[i];
        m[i] = mx;
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] = o[j][0] * c[0] + pa[2 + j * 8 + d] * cg[0];
        o[j][1] = o[j][1] * c[0] + pa[3 + j * 8 + d] * cg[0];
        o[j][2] = o[j][2] * c[1] + pb[2 + j * 8 + d] * cg[1];
        o[j][3] = o[j][3] * c[1] + pb[3 + j * 8 + d] * cg[1];
      }
    }
  }
  const float inv_a = 1.f / l[0], inv_b = 1.f / l[1];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (ra < Tn)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ra * H * DH + j * 8 + d) =
          __floats2bfloat162_rn(o[j][0] * inv_a, o[j][1] * inv_a);
    if (rb < Tn)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rb * H * DH + j * 8 + d) =
          __floats2bfloat162_rn(o[j][2] * inv_b, o[j][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
template <int DH, int KT, int G>
static int k4_launch_tc_dh(const K4Args* a, cudaStream_t st) {
  const K4Shape* s = a->s;
  const dim3 grid((s->T + K4T_QT - 1) / K4T_QT, s->B * s->H);
  k4_prefill_tc<DH, KT, G><<<grid, K4T_WARPS * 32 * G, 0, st>>>(
      (const bf16*)a->q, (const bf16*)a->k, (const bf16*)a->v, a->x_lens, a->xy_lens,
      (bf16*)a->out, a->err, s->T, s->H, s->q_sb, s->q_st, s->q_sh, s->k_sb, s->k_st, s->k_sh,
      s->v_sb, s->v_st, s->v_sh, 1.4426950408889634f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

static int k4_launch_tc(const K4Args* a, cudaStream_t st) {
  // (head dim, keys a warp takes of a step, key groups): two stages of K and V
  // and the groups' partials in 48 KB of static shared memory, at most 512
  // threads (128 registers each)
  switch (a->s->Dh) {
    case 8: return k4_launch_tc_dh<8, 32, 4>(a, st);
    case 16: return k4_launch_tc_dh<16, 32, 4>(a, st);
    case 32: return k4_launch_tc_dh<32, 32, 4>(a, st);
    case 64: return k4_launch_tc_dh<64, 32, 2>(a, st);
    case 128: return k4_launch_tc_dh<128, 32, 1>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int DH, int KT>
static int k4_launch_dh(const K4Args* a, cudaStream_t st) {
  const K4Shape* s = a->s;
  const dim3 grid(s->B * s->H, (s->T + K4_QT - 1) / K4_QT);
  k4_prefill<DH, KT><<<grid, K4_WARPS * 32, 0, st>>>(
      (const float*)a->q, (const float*)a->k, (const float*)a->v, a->x_lens, a->xy_lens,
      (float*)a->out, a->err, s->T, s->H, s->q_sb, s->q_st, s->q_sh, s->k_sb, s->k_st, s->k_sh,
      s->v_sb, s->v_st, s->v_sh, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

static int k4_launch(const K4Args* a, cudaStream_t st) {
  // (float32 tiles of 128-wide heads do not fit the static shared memory)
  switch (a->s->Dh) {
    case 8: return k4_launch_dh<8, 64>(a, st);
    case 16: return k4_launch_dh<16, 64>(a, st);
    case 32: return k4_launch_dh<32, 64>(a, st);
    case 64: return k4_launch_dh<64, 64>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

static bool k4_shape_ok(const K4Shape* s) { return s->B >= 1 && s->T >= 1 && s->H >= 1; }

// The host entry point: bf16 on the tensor cores, float32 on the CUDA cores.
// Returns the CUDA error of the launch (0 = accepted).
extern "C" int k4_flash_prefill(const void* q, const void* k, const void* v, const int* x_lens,
                                const int* xy_lens, void* out, int* err, const K4Shape* shape,
                                void* stream) {
  const K4Args a{q, k, v, x_lens, xy_lens, out, err, shape};
  cudaStream_t st = (cudaStream_t)stream;
  if (!k4_shape_ok(shape)) return (int)cudaErrorInvalidValue;
  return shape->is_f32 ? k4_launch(&a, st) : k4_launch_tc(&a, st);
}
