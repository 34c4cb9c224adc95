// P2: the reduction and mask constructs of the decode kernels' per-row
// online softmax, as a probe on Hopper (sm_90a).
//
// Replaces the TPU probe tools/mosaic_probe.py:run_variant (its pallas_call
// at :88, body _kernel at :33), which held each construct alone to see
// whether Mosaic lowers it.  One block of 256 threads reduces x [256, 16]
// float32 (in shared memory) to out [1, 16]; x is also read as
// [B, BLOCK, H] = [4, 64, 16] with the fixed lengths 10 / 20 / 30 / 40:
//   0 baseline  max + sum over all 256 rows (2-D only);
//   1 reduce3d  max + sum over each block's 64 rows, block 0 written;
//   2 bcastcmp  block sums with rows at or past the block's length set to
//               -1e9 (the iota-versus-[B, 1, 1] compare mask), block 0 written;
//   3 combined  three passes of a loop carrying acc [1, 16] (in shared
//               memory): y = x + acc[0, 0] (that one scalar on every element),
//               m = each block's max of y over its 64 rows (before the mask),
//               acc += block 0's sum of exp(y - m) over its rows below 10.
// Every variant but baseline reduces all four blocks, as the TPU kernel's
// 3-D reduce does, and writes block 0 (its [0:1]).
//
// What bounds it on this card: nothing but the launch -- 16 KB in and 64
// bytes out are 5 ns at 3.35 TB/s.  The probe holds the constructs on the
// card: a thread owns 16 rows of one (block, column), the partials meet in
// shared memory in a fixed order, so a result does not depend on timing.
#include <cuda_runtime.h>

#include <cmath>

constexpr int P2_B = 4, P2_BLOCK = 64, P2_H = 16;
constexpr int P2_ROWS = P2_B * P2_BLOCK;
constexpr int P2_THREADS = 256;
constexpr int P2_SLICES = P2_THREADS / (P2_B * P2_H);  // 4 slices of 16 rows a block
constexpr int P2_SLICE_ROWS = P2_BLOCK / P2_SLICES;

enum { P2_BASELINE = 0, P2_REDUCE3D = 1, P2_BCASTCMP = 2, P2_COMBINED = 3 };

__global__ void __launch_bounds__(P2_THREADS) p2_kernel(const float* __restrict__ x,
                                                        float* __restrict__ out, int variant) {
  __shared__ __align__(16) float xs[P2_ROWS * P2_H];
  __shared__ float pmax[P2_THREADS], psum[P2_THREADS];  // a thread's partials
  __shared__ float bmax[P2_B * P2_H];                   // [B, H]: each block's max
  __shared__ float acc[P2_H];
  const int lens[P2_B] = {10, 20, 30, 40};
  const int t = threadIdx.x;
  for (int i = t; i < P2_ROWS * P2_H / 4; i += P2_THREADS)
    reinterpret_cast<float4*>(xs)[i] = reinterpret_cast<const float4*>(x)[i];
  __syncthreads();

  if (variant == P2_BASELINE) {  // thread (slice, column): rows 16 slice .. 16 slice + 15
    const int h = t % P2_H, s = t / P2_H;
    float m = -INFINITY, sum = 0.f;
    for (int r = 16 * s; r < 16 * s + 16; ++r) {
      const float v = xs[r * P2_H + h];
      m = fmaxf(m, v);
      sum += v;
    }
    pmax[t] = m;
    psum[t] = sum;
    __syncthreads();
    if (t < P2_H) {
      float M = pmax[t], S = psum[t];
      for (int s2 = 1; s2 < P2_THREADS / P2_H; ++s2) {
        M = fmaxf(M, pmax[s2 * P2_H + t]);
        S += psum[s2 * P2_H + t];
      }
      out[t] = M + S;
    }
    return;
  }

  // thread t: column h of block b, rows [P2_SLICE_ROWS * s, + P2_SLICE_ROWS) of the block;
  // partial index t = (s * P2_B + b) * P2_H + h
  const int h = t % P2_H, b = (t / P2_H) % P2_B, s = t / (P2_H * P2_B);
  const int row0 = P2_SLICE_ROWS * s;  // within the block
  const float* xb = xs + (size_t)(b * P2_BLOCK + row0) * P2_H + h;
  // slice-ordered combination of the four partials of (block bb, column hh)
  auto slices_max = [&](int bh) {
    float M = pmax[bh];
    for (int s2 = 1; s2 < P2_SLICES; ++s2) M = fmaxf(M, pmax[s2 * P2_B * P2_H + bh]);
    return M;
  };
  auto slices_sum = [&](int bh) {
    float S = psum[bh];
    for (int s2 = 1; s2 < P2_SLICES; ++s2) S += psum[s2 * P2_B * P2_H + bh];
    return S;
  };

  if (variant == P2_REDUCE3D || variant == P2_BCASTCMP) {
    const bool masked = variant == P2_BCASTCMP;
    float m = -INFINITY, sum = 0.f;
    for (int i = 0; i < P2_SLICE_ROWS; ++i) {
      float v = xb[i * P2_H];
      if (masked && !(row0 + i < lens[b])) v = -1e9f;
      m = fmaxf(m, v);
      sum += v;
    }
    pmax[t] = m;
    psum[t] = sum;
    __syncthreads();
    if (t < P2_B * P2_H) {  // [B, H]: every block's result; block 0's is the output
      const float r = masked ? slices_sum(t) : slices_max(t) + slices_sum(t);
      if (t < P2_H) out[t] = r;
    }
    return;
  }

  // combined
  if (t < P2_H) acc[t] = 0.f;
  __syncthreads();
  for (int pass = 0; pass < 3; ++pass) {
    const float a00 = acc[0];
    float m = -INFINITY;
    for (int i = 0; i < P2_SLICE_ROWS; ++i) m = fmaxf(m, xb[i * P2_H] + a00);
    pmax[t] = m;
    __syncthreads();
    if (t < P2_B * P2_H) bmax[t] = slices_max(t);
    __syncthreads();
    const float mb = bmax[b * P2_H + h];
    float sum = 0.f;
    for (int i = 0; i < P2_SLICE_ROWS; ++i)
      if (row0 + i < lens[b]) sum += expf(xb[i * P2_H] + a00 - mb);
    psum[t] = sum;
    __syncthreads();
    if (t < P2_H) acc[t] += slices_sum(t);  // block 0's sum (index b = 0, h = t)
    __syncthreads();
  }
  if (t < P2_H) out[t] = acc[t];
}

// x [256, 16] float32 (16-byte aligned) -> out [16] float32 on ``stream``.
// Returns the CUDA error of the launch (0 = accepted).
extern "C" int p2_mosaic_probe(const void* x, void* out, int variant, void* stream) {
  if (variant < P2_BASELINE || variant > P2_COMBINED) return (int)cudaErrorInvalidValue;
  p2_kernel<<<1, P2_THREADS, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, variant);
  return (int)cudaGetLastError();
}
