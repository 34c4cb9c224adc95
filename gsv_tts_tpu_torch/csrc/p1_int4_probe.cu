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
//   * unpack: every thread reads its packed bytes straight from global memory;
//   * unpack_dma: one warp first copies the block's packed bytes into slot 0
//     of a two-slot shared buffer by 1-D bulk asynchronous copies counted on
//     an mbarrier (the TPU's make_async_copy + wait into a VMEM scratch), and
//     the block unpacks from there.  Where the block's run of columns is
//     whole rows (the probe's shape: one block, a 64 KB page, slots of 2 x 64
//     KB) that is ONE copy; otherwise one copy of ``cols`` bytes a row.
//
// What bounds it on this card: bytes, at the card's scale -- 90 KB in and
// out is 0.03 us at 3.35 TB/s, and 2.1 MFLOP is 2 ns of the bf16 peak.  The
// kernel does not work at that scale: a block takes up to 256 byte columns,
// so the probe's shape runs on ONE SM (the flagship MLP-1 on 8), and a call
// is that SM's instruction issue -- per packed byte a sign extension, a
// shift, a mask, an xor, a subtract and two int -> bf16 -> float
// conversions, then 16 FMAs (8 rows x two columns) on the CUDA cores.  That
// chain is what the probe isolates.  The product is in the kernel's body,
// not a library's.
//
// Design: a block takes ``cols`` byte columns (2 * cols output columns) and
// 256 threads; a thread owns 4 adjacent byte columns (one 32-bit load a row)
// and a slice of the D rows (the block's cols / 4 column groups times
// 256 / (cols / 4) slices), keeps 8 rows x 8 columns of float32 sums in
// registers, and the slices' sums meet in shared memory and are added in
// slice order (the result does not depend on timing).  The wrapper
// (gsv_tts_tpu_torch/tools/int4_probe.py) picks ``cols``.
#include <cuda_bf16.h>

#include "probe_common.cuh"

constexpr int P1_THREADS = 256;
constexpr int P1_XROWS = 8;                           // rows of x and out
constexpr int P1_PART_BYTES = 4 * P1_THREADS * 64;    // the slices' sums: 64 floats a thread

// Dynamic shared memory: [slots: 2 * D * cols bytes (unpack_dma only)]
// [x as bf16-rounded float: 8 * D] [the slices' sums] [the mbarrier].
static __host__ __device__ inline size_t p1_smem(int D, int cols, bool dma) {
  return (dma ? 2 * (size_t)D * cols : 0) + 4 * (size_t)P1_XROWS * D + P1_PART_BYTES + 16;
}

template <bool DMA>
__global__ void __launch_bounds__(P1_THREADS) p1_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ packed,
    const float* __restrict__ scale, float* __restrict__ out, int* err, int D, int half,
    int cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t slot_bytes = DMA ? (size_t)D * cols : 0;
  int8_t* slot0 = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + 2 * slot_bytes);
  float* part = xs + P1_XROWS * D;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(part + P1_PART_BYTES / 4);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * cols;  // the block's first byte column

  if (DMA) {
    if (tid == 0) mbar_init(bar, 1);
    __syncthreads();
    if (tid < 32) {
      if (tid == 0) mbar_expect(bar, (uint32_t)slot_bytes);
      if (cols == half) {  // whole rows: the page is one contiguous run
        if (tid == 0) bulk_copy(slot0, packed, (uint32_t)slot_bytes, bar);
      } else {
        for (int k = tid; k < D; k += 32)
          bulk_copy(slot0 + (size_t)k * cols, packed + (size_t)k * half + c0,
                          (uint32_t)cols, bar);
      }
    }
  }
  for (int i = tid; i < P1_XROWS * D; i += P1_THREADS)
    xs[i] = __bfloat162float(__float2bfloat16_rn(x[i]));
  __syncthreads();

  const int8_t* src = packed + c0;
  size_t stride = half;
  if (DMA) {
    probe_wait(bar, 0, err);
    src = slot0;
    stride = cols;
  }
  const int groups = cols / 4, slices = P1_THREADS / groups;
  const int g = tid % groups, s = tid / groups;
  float acc_lo[P1_XROWS][4], acc_hi[P1_XROWS][4];
#pragma unroll
  for (int r = 0; r < P1_XROWS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_lo[r][j] = acc_hi[r][j] = 0.f;

  for (int k = s; k < D; k += slices) {
    const uint32_t word = *reinterpret_cast<const uint32_t*>(src + (size_t)k * stride + 4 * g);
    float lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = (int)(int8_t)(word >> (8 * j));  // sign-extended byte
      hi[j] = __bfloat162float(__int2bfloat16_rn(b >> 4));
      lo[j] = __bfloat162float(__int2bfloat16_rn(((b & 15) ^ 8) - 8));
    }
#pragma unroll
    for (int r = 0; r < P1_XROWS; ++r) {
      const float xv = xs[r * D + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc_lo[r][j] = fmaf(xv, lo[j], acc_lo[r][j]);
        acc_hi[r][j] = fmaf(xv, hi[j], acc_hi[r][j]);
      }
    }
  }

  // part[s][r][c], c over the block's 2 * cols output columns (low nibbles first)
  const int width = 2 * cols;
  float* mine = part + (size_t)s * P1_XROWS * width;
#pragma unroll
  for (int r = 0; r < P1_XROWS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mine[r * width + 4 * g + j] = acc_lo[r][j];
      mine[r * width + cols + 4 * g + j] = acc_hi[r][j];
    }
  __syncthreads();
  const int N = 2 * half;
  for (int i = tid; i < P1_XROWS * width; i += P1_THREADS) {
    float sum = 0.f;
    for (int t = 0; t < slices; ++t) sum += part[(size_t)t * P1_XROWS * width + i];
    const int r = i / width, c = i % width;
    const int col = c < cols ? c0 + c : half + c0 + (c - cols);
    out[(size_t)r * N + col] = sum * scale[col];
  }
}

// x [8, D] float32, packed [D, half] int8, scale [2 * half] float32 ->
// out [8, 2 * half] float32, on ``stream``.  ``cols`` (the byte columns a
// block takes) divides ``half``, is a multiple of 16 and, divided by 4,
// divides 256.  Returns the CUDA error of the launch (0 = accepted).
extern "C" int p1_int4_unpack_matmul(const void* x, const void* packed, const void* scale,
                                     void* out, int* err, int D, int half, int cols, int dma,
                                     void* stream) {
  static unsigned long long smem_set[2] = {0, 0};
  if (D < 1 || half < 16 || cols < 16 || cols > 4 * P1_THREADS || cols % 16 != 0 ||
      half % cols != 0 || P1_THREADS % (cols / 4) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = p1_smem(D, cols, dma != 0);
  if (smem > SMEM_OPTIN) return (int)cudaErrorInvalidValue;
  const void* kernel =
      dma ? (const void*)p1_kernel<true> : (const void*)p1_kernel<false>;
  int rc = probe_allow_smem(kernel, &smem_set[dma ? 1 : 0]);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (dma)
    p1_kernel<true><<<half / cols, P1_THREADS, smem, st>>>(
        (const float*)x, (const int8_t*)packed, (const float*)scale, (float*)out, err, D, half,
        cols);
  else
    p1_kernel<false><<<half / cols, P1_THREADS, smem, st>>>(
        (const float*)x, (const int8_t*)packed, (const float*)scale, (float*)out, err, D, half,
        cols);
  return (int)cudaGetLastError();
}
