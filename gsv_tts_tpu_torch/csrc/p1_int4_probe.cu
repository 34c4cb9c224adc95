// P1: the int4 nibble unpack and its product, as a probe on Hopper (sm_90a).
//
// Replaces the TPU probe tools/int4_probe.py:run_variant (its pallas_call at
// :83, body _kernel at :32).  It computes
//
//   b   = packed (int8, sign-extended to int32)      [D, N/2]
//   hi  = b >> 4                                     (arithmetic)
//   lo  = ((b & 15) ^ 8) - 8                         (the low nibble, signed)
//   w   = concat([lo, hi], axis=1) as bf16           [D, N]
//   out = (bf16(x) @ w) * scale                      [8, N] float32
//
// so byte column j carries output column j in its low nibble and column
// j + N/2 in its high one, and the per-lane scale multiplies the finished
// float32 sum.  Two variants, as on the TPU:
//   * unpack: every thread reads its packed bytes from global memory
//     straight into registers (16-byte loads, the next stage's in flight
//     while this one is multiplied);
//   * unpack_dma: the block's bytes stream through a ring of shared-memory
//     slots filled by 1-D bulk asynchronous copies (one a row of the block's
//     column tile) counted on an mbarrier a slot (the TPU's make_async_copy
//     + wait into a two-slot VMEM scratch, generalised to ``ring`` slots).
//
// What bounds it on this card: bytes.  At the s1v3 layer stack as one page
// (D = 12288, N = 6144) the call moves 38.4 MB (0.0115 ms at 3.35 TB/s) and
// does 1.2 GFLOP (0.0012 ms of the bf16 tensor cores); at the probe's shape
// and the MLP-1 a call is the launch and one or two trips to memory.
//
// Design (the redesign of a first design that took a block per <= 256 byte
// columns carrying all of D with float32 FMAs on the CUDA cores):
//   * the products on the tensor cores: out^T[N, 8] = w^T[N, D] . x^T[D, 8]
//     as mma.sync m16n8k16 (bf16 in, float32 sums): the 8 rows of x are the
//     n = 8 side, the weights the 16 x 16 A operand, built in registers.
//     A warp takes 128 byte columns (256 output columns) and 16 rows a
//     step: lane (g = lane / 4, t = lane % 4) loads 16 bytes of rows
//     t, t + 4, t + 8, t + 12; byte b of its 16 is mma b's A rows g (the low
//     nibble's column) and g + 8 (the high nibble's), and its four rows are
//     the mma's k indices 2t, 2t + 1, 2t + 8, 2t + 9.  x is staged once per
//     block in shared memory as bf16 with each 16-row run permuted to match,
//     so a lane's B fragment is one 8-byte load;
//   * the unpack in registers, two values at a time, no int -> float
//     conversion: a byte permute puts one byte column of two rows into the
//     word's bytes 0 and 2; one lop3 takes nibble pairs (bits 0-3, 16-19)
//     xor 8 (v + 8 = u in [0, 15]) into the mantissas of the bf16 pair
//     0x4300 0x4300 (128 + u exactly); one bf16x2 fma subtracts 136: v;
//   * the whole card: a block (8 warps) takes a column tile of 128 x
//     col_warps bytes and one of ``splits`` runs of D's rows (whole stages
//     of 16 x k_warps rows), so every shape fills the SMs and x's slice and
//     a block's slots fit shared memory at any D.  The warps' sums meet in
//     shared memory and the splits' in a second small pass
//     (p1_sum_splits, a programmatic dependent launch: its launch overlaps
//     the main grid's tail), each added in a fixed order: no atomics, so a
//     result does not depend on timing.  The scale multiplies the finished
//     sum once.
//   The plan (col_warps, splits, stages, ring) is the wrapper's
//   (gsv_tts_tpu_torch/tools/int4_probe.py:plan), which the CPU tests check.
#include <cuda_bf16.h>

#include "probe_common.cuh"

constexpr int P1_THREADS = 256;
constexpr int P1_XROWS = 8;                         // rows of x and out
constexpr int P1_WARPS = P1_THREADS / 32;
constexpr int P1_WARP_BYTES = 128;                  // a warp's byte columns: 16 a lane group
constexpr int P1_PS = 2 * P1_WARP_BYTES + 4;        // a row of a warp's sums in shared memory
constexpr int P1_SCRATCH = P1_WARPS * P1_XROWS * P1_PS * 4;  // the warps' sums: 66,560 bytes
constexpr int P1_RING_PAD = 32;  // bytes after each row of a slot: the lanes' 16-byte reads
                                 // of rows t + 4i meet no bank twice

struct P1Args {
  const float* x;            // [8, D]
  const uint8_t* packed;     // [D, half]
  const float* scale;        // [2 * half]
  float* out;                // [8, 2 * half], or the splits' partials [splits, 8, 2 * half]
  int* err;
  int D, half;
  int col_log;               // log2 of the warps across a block's column tile
  int per, extra;            // stages a split (blockIdx.y): per, one more for the first extra
  int splits;
  int ring;                  // unpack_dma: slots of the ring (unpack: 0)
  int xs;                    // a row of the staged x slice, in bf16 elements
};

// Dynamic shared memory: [the ring's slots (unpack_dma), reused after the
// last stage for the warps' sums; at least P1_SCRATCH bytes]
// [x's slice: 8 rows of ``xs`` bf16] [the ring's mbarriers].
static inline size_t p1_slot_bytes(int col_warps) {
  const int rows = 16 * (P1_WARPS / col_warps);
  return (size_t)rows * (P1_WARP_BYTES * col_warps + P1_RING_PAD);
}
static inline size_t p1_region(int col_warps, int ring, bool dma) {
  const size_t slots = dma ? (size_t)ring * p1_slot_bytes(col_warps) : 0;
  return slots > (size_t)P1_SCRATCH ? slots : (size_t)P1_SCRATCH;
}
static inline size_t p1_smem(int col_warps, int ring, int xs, bool dma) {
  return p1_region(col_warps, ring, dma) + 2 * (size_t)P1_XROWS * xs + 8 * (size_t)ring;
}

// Bits 0-3 and 16-19 of ``w`` are two signed nibbles v: xor 8 makes each
// u = v + 8 in [0, 15], which the lop3 (b ? a ^ c : c, with b the nibbles'
// mask and c = 0x4308 4308: the xor's 8 inside the mask, the bf16 128.0's
// bits outside it) writes into the bf16 pair 128 + u; one fma of 1 and
// -136 (0xC308) leaves v, exactly.
static __device__ __forceinline__ uint32_t p1_nibbles_bf16(uint32_t w) {
  uint32_t r, v;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(r) : "r"(w), "r"(0x000F000Fu), "r"(0x43084308u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(v) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return v;
}

// c += a . b on one m16n8k16 tile: bf16 inputs, float32 sums
static __device__ __forceinline__ void p1_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-row step of a warp.  ``v[i]``: the lane's 16 bytes of row t + 4i;
// ``xp``: x's staged row g at the step's rows, lane t's four (rows t, t + 4,
// t + 8, t + 12 of the step, in that order).  acc[b]: byte b's mma (rows g:
// the low nibble's column, g + 8: the high nibble's; columns 2t, 2t + 1: x's
// rows).
static __device__ __forceinline__ void p1_step(float (&acc)[16][4], const uint4 (&v)[4],
                                               const __nv_bfloat16* xp) {
  const uint2 xb = *reinterpret_cast<const uint2*>(xp);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t r0 = reinterpret_cast<const uint32_t*>(&v[0])[w];
    const uint32_t r1 = reinterpret_cast<const uint32_t*>(&v[1])[w];
    const uint32_t r2 = reinterpret_cast<const uint32_t*>(&v[2])[w];
    const uint32_t r3 = reinterpret_cast<const uint32_t*>(&v[3])[w];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // bytes 2h, 2h + 1 of the word: of rows t, t + 4 (resp. t + 8, t + 12)
      // into the word's bytes 0, 1 and 2, 3
      const uint32_t sel = h ? 0x7632u : 0x5410u;
      const uint32_t p01 = __byte_perm(r0, r1, sel), p23 = __byte_perm(r2, r3, sel);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t a[4] = {p1_nibbles_bf16(p01 >> (8 * e)), p1_nibbles_bf16(p01 >> (8 * e + 4)),
                               p1_nibbles_bf16(p23 >> (8 * e)), p1_nibbles_bf16(p23 >> (8 * e + 4))};
        p1_mma(acc[4 * w + 2 * h + e], a, xb.x, xb.y);
      }
    }
  }
}

template <bool DMA>
__global__ void __launch_bounds__(P1_THREADS, 2) p1_kernel(const P1Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // no division by a value known only at run time: the compiler turns one
  // into an int -> float conversion and a reciprocal
  const int cw_n = 1 << a.col_log, kw_n = P1_WARPS >> a.col_log;
  const int cw = warp & (cw_n - 1), kw = warp >> a.col_log;
  const int tile = P1_WARP_BYTES * cw_n;  // the block's byte columns
  const int sr = 16 * kw_n;               // rows of a stage
  const int rs = tile + P1_RING_PAD;      // a slot's row stride
  const int c0 = blockIdx.x * tile;       // the block's first byte column
  const int split = blockIdx.y;
  const int st0 = split * a.per + min(split, a.extra);
  const int n_st = a.per + (split < a.extra ? 1 : 0);
  const int row0 = st0 * sr, row1 = min((st0 + n_st) * sr, a.D);
  const size_t slot_bytes = (size_t)sr * rs;  // p1_slot_bytes, p1_region without their division
  const size_t ring_bytes = DMA ? a.ring * slot_bytes : 0;
  const size_t region = ring_bytes > (size_t)P1_SCRATCH ? ring_bytes : (size_t)P1_SCRATCH;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + region);
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(smem + region + 2 * (size_t)P1_XROWS * a.xs);

  // stage s of the split (its rows row0 + s * sr ..) into slot ``k`` (s mod
  // ring): one copy of the tile's bytes a row, thread r issuing row r's
  auto issue = [&](int s, int k) {
    const int r0 = row0 + s * sr, rows = min(sr, row1 - r0);
    unsigned char* slot = smem + (size_t)k * slot_bytes;
    if (tid == 0) mbar_expect(bar + k, (uint32_t)(rows * tile));
    if (tid < rows)
      bulk_copy(slot + (size_t)tid * rs, a.packed + (size_t)(r0 + tid) * a.half + c0,
                (uint32_t)tile, bar + k);
  };
  // unpack: the lane's 16 bytes of rows t + 4i of the warp's step in stage s
  const unsigned char* gp = a.packed + (size_t)(row0 + 16 * kw + t) * a.half + c0 +
                            P1_WARP_BYTES * cw + 16 * g;
  auto load = [&](uint4 (&v)[4], int s) {
    const unsigned char* p = gp + (size_t)s * sr * a.half;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = __ldcs(reinterpret_cast<const uint4*>(p + (size_t)4 * i * a.half));
  };
  // whether the warp has a step in stage s (the last stage of D may be short)
  auto has = [&](int s) { return s < n_st && row0 + s * sr + 16 * kw < row1; };

  uint4 va[4], vb[4];
  if (DMA) {
    if (tid == 0) mbar_init(bar, a.ring);
    __syncthreads();
    for (int s = 0; s < min(a.ring, n_st); ++s) issue(s, s);
  } else if (has(0)) {
    load(va, 0);  // in flight while x is staged
  }

  // x's rows row0 .. row1 as bf16, each 16-row run permuted so that lane t's
  // rows t, t + 4, t + 8, t + 12 are adjacent: a thread's float4 of every x
  // row in flight together (row k = 4 k4 + c goes to 16-row run k4 / 4,
  // place 4c + k4 % 4)
  const int rows = row1 - row0;
  for (int k4 = tid; k4 < (rows >> 2); k4 += P1_THREADS) {
    float4 f[P1_XROWS];
#pragma unroll
    for (int r = 0; r < P1_XROWS; ++r)
      f[r] = __ldg(reinterpret_cast<const float4*>(a.x + (size_t)r * a.D + row0) + k4);
    __nv_bfloat16* dst = xs + 4 * (k4 & ~3) + (k4 & 3);
#pragma unroll
    for (int r = 0; r < P1_XROWS; ++r) {
      dst[r * a.xs] = __float2bfloat16_rn(f[r].x);
      dst[r * a.xs + 4] = __float2bfloat16_rn(f[r].y);
      dst[r * a.xs + 8] = __float2bfloat16_rn(f[r].z);
      dst[r * a.xs + 12] = __float2bfloat16_rn(f[r].w);
    }
  }
  __syncthreads();

  float acc[16][4];
#pragma unroll
  for (int b = 0; b < 16; ++b) acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
  const __nv_bfloat16* xg = xs + g * a.xs + 16 * kw + 4 * t;  // + s * sr: stage s's step

  if (DMA) {
    const unsigned char* sp = smem + (size_t)(16 * kw + t) * rs + P1_WARP_BYTES * cw + 16 * g;
    int k = 0;            // stage s's slot: s mod ring
    uint32_t parity = 0;  // its use: s / ring, mod 2
    for (int s = 0; s < n_st; ++s) {
      probe_wait(bar + k, parity, a.err);
      if (has(s)) {
        const unsigned char* p = sp + (size_t)k * slot_bytes;
#pragma unroll
        for (int i = 0; i < 4; ++i) va[i] = *reinterpret_cast<const uint4*>(p + (size_t)4 * i * rs);
        p1_step(acc, va, xg + s * sr);
      }
      __syncthreads();  // every warp is done with the slot: refill it
      if (s + a.ring < n_st) issue(s + a.ring, k);
      if (++k == a.ring) {
        k = 0;
        parity ^= 1u;
      }
    }
  } else {
    for (int s = 0; s < n_st; s += 2) {  // two stages a turn: va, vb in flight in turns
      if (has(s + 1)) load(vb, s + 1);
      if (has(s)) p1_step(acc, va, xg + s * sr);
      if (has(s + 2)) load(va, s + 2);
      if (has(s + 1)) p1_step(acc, vb, xg + (s + 1) * sr);
    }
  }

  // the second pass (where D is split) may start launching: it waits for
  // this grid's end before it reads a partial
  asm volatile("griddepcontrol.launch_dependents;\n");
  // each warp's sums into its 8 rows of P1_PS floats: the low nibbles'
  // columns at 8b + g, the high ones' at 128 + 8b + g (no bank twice)
  float* sc = reinterpret_cast<float*>(smem) + warp * P1_XROWS * P1_PS;
#pragma unroll
  for (int b = 0; b < 16; ++b)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[(2 * t + e) * P1_PS + 8 * b + g] = acc[b][e];
      sc[(2 * t + e) * P1_PS + P1_WARP_BYTES + 8 * b + g] = acc[b][2 + e];
    }
  __syncthreads();
  // the block's outputs [8 rows][col warps][low, high][128], column fastest,
  // four adjacent columns a thread (one 16-byte store): the k warps' sums
  // loaded together and added in warp order, then the scale (one split) or
  // the split's partial
  const int N = 2 * a.half;
  const float* all = reinterpret_cast<const float*>(smem);
#pragma unroll 2
  for (int i = 4 * tid; i < P1_XROWS * cw_n * 2 * P1_WARP_BYTES; i += 4 * P1_THREADS) {
    const int p = i & (P1_WARP_BYTES - 1), hl = (i >> 7) & 1, rest = i >> 8;
    const int cwi = rest & (cw_n - 1), r = rest >> a.col_log;
    const float* w = all + cwi * P1_XROWS * P1_PS + r * P1_PS + hl * P1_WARP_BYTES +
                     8 * (p & 15) + (p >> 4);  // column p + c at w + 8c
    float v[P1_WARPS][4];
#pragma unroll
    for (int k = 0; k < P1_WARPS; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[k][c] = k < kw_n ? w[k * cw_n * P1_XROWS * P1_PS + 8 * c] : 0.f;
    float4 sum = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
#pragma unroll
    for (int k = 1; k < P1_WARPS; ++k)
      if (k < kw_n) {
        sum.x += v[k][0];
        sum.y += v[k][1];
        sum.z += v[k][2];
        sum.w += v[k][3];
      }
    const int col = c0 + P1_WARP_BYTES * cwi + p + hl * a.half;
    if (a.splits == 1) {
      const float4 sc = *reinterpret_cast<const float4*>(a.scale + col);
      sum = make_float4(sum.x * sc.x, sum.y * sc.y, sum.z * sc.z, sum.w * sc.w);
      *reinterpret_cast<float4*>(a.out + (size_t)r * N + col) = sum;
    } else {
      *reinterpret_cast<float4*>(a.out + ((size_t)split * P1_XROWS + r) * N + col) = sum;
    }
  }
}

// The second pass where D is split: out[r, c] = scale[c] * the splits'
// partials summed in split order (blockIdx.y: the row r).  Launched as a
// programmatic dependent of p1_kernel, so its launch overlaps the main
// grid's last blocks; it waits for that grid before reading.
__global__ void __launch_bounds__(P1_THREADS) p1_sum_splits(const float* __restrict__ part,
                                                            const float* __restrict__ scale,
                                                            float* __restrict__ out, int N,
                                                            int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int c = blockIdx.x * P1_THREADS + threadIdx.x, r = blockIdx.y;
  if (c >= N) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += part[((size_t)s * P1_XROWS + r) * N + c];
  out[(size_t)r * N + c] = sum * scale[c];
}

// x [8, D] float32, packed [D, half] int8, scale [2 * half] float32 ->
// out [8, 2 * half] float32, on ``stream``; ``part`` holds the splits'
// partials [splits, 8, 2 * half] when ``splits`` > 1 (unused otherwise).
// The plan: ``col_warps`` in {1, 2, 4, 8} with half a multiple of
// 128 * col_warps; D a multiple of 16; ``stages`` = D / (16 * 8 / col_warps)
// rounded up, split stages / splits a split and one more for the first
// stages % splits; 1 <= splits <= stages; ``ring`` slots (unpack_dma: >= 1;
// unpack: 0);
// ``xs`` >= the rows of the longest split, a multiple of 4.  One launch, two
// where D is split.  Returns the CUDA error of the launches (0 = accepted).
extern "C" int p1_int4_unpack_matmul(const void* x, const void* packed, const void* scale,
                                     void* out, void* part, int* err, int D, int half,
                                     int col_warps, int stages, int splits, int ring, int xs,
                                     int dma, void* stream) {
  static unsigned long long smem_set[2] = {0, 0};
  if (col_warps != 1 && col_warps != 2 && col_warps != 4 && col_warps != 8)
    return (int)cudaErrorInvalidValue;
  const int sr = 16 * (P1_WARPS / col_warps);
  if (D < 16 || D % 16 != 0 || half < P1_WARP_BYTES * col_warps ||
      half % (P1_WARP_BYTES * col_warps) != 0 || stages != (D + sr - 1) / sr || splits < 1 ||
      splits > stages || splits > 65535 || ring < (dma ? 1 : 0) || xs % 4 != 0 ||
      xs < ((stages + splits - 1) / splits) * sr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = p1_smem(col_warps, ring, xs, dma != 0);
  if (smem > SMEM_OPTIN) return (int)cudaErrorInvalidValue;
  const void* kernel = dma ? (const void*)p1_kernel<true> : (const void*)p1_kernel<false>;
  int rc = probe_allow_smem(kernel, &smem_set[dma ? 1 : 0]);
  if (rc) return rc;
  const int col_log = col_warps == 1 ? 0 : col_warps == 2 ? 1 : col_warps == 4 ? 2 : 3;
  const P1Args args{(const float*)x, (const uint8_t*)packed, (const float*)scale,
                    (float*)(splits > 1 ? part : out), err, D, half, col_log, stages / splits,
                    stages % splits, splits, ring, xs};
  const dim3 grid(half / (P1_WARP_BYTES * col_warps), splits);
  cudaStream_t st = (cudaStream_t)stream;
  if (dma)
    p1_kernel<true><<<grid, P1_THREADS, smem, st>>>(args);
  else
    p1_kernel<false><<<grid, P1_THREADS, smem, st>>>(args);
  rc = (int)cudaGetLastError();
  if (rc || splits == 1) return rc;
  const int N = 2 * half;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + P1_THREADS - 1) / P1_THREADS, P1_XROWS);
  cfg.blockDim = dim3(P1_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, p1_sum_splits, (const float*)part, (const float*)scale,
                               (float*)out, N, splits);
  return rc ? rc : (int)cudaGetLastError();
}
