// P2: the reduction and mask constructs of the decode kernels' per-row
// online softmax, as a probe on Hopper (sm_90a).
//
// Replaces the TPU probe tools/mosaic_probe.py:run_variant (its pallas_call
// at :88, body _kernel at :33), which held each construct alone to see
// whether Mosaic lowers it.  x [256, 16] float32 -> out [1, 16]; x is also
// read as [B, BLOCK, H] = [4, 64, 16] with the fixed lengths 10 / 20 / 30 / 40:
//   0 baseline  max + sum over all 256 rows (2-D only);
//   1 reduce3d  max + sum over each block's 64 rows, block 0 written;
//   2 bcastcmp  block sums with rows at or past the block's length set to
//               -1e9 (the iota-versus-[B, 1, 1] compare mask), block 0 written;
//   3 combined  three passes of a loop carrying acc [1, 16]: y = x + acc[0, 0]
//               (that one scalar on every element), m = each block's max of y
//               over its 64 rows (before the mask), acc += block 0's sum of
//               exp(y - m) over its rows below 10.
// Every variant but baseline reduces all four blocks, as the TPU kernel's
// 3-D reduce does, and writes block 0 (its [0:1]).
//
// What bounds it on this card: nothing but the launch -- 16 KB in and 64
// bytes out are 5 ns at 3.35 TB/s.  So the design (the redesign of a first
// design in which a thread owned 16 rows of one (block, column) and the
// partials met in shared memory) spends as little as it can past the
// launch: one block of 4 warps, warp b on block b of x.  A lane (row lane j = lane / 4, column quad q = lane % 4) reads its
// rows j, j + 8, ..., j + 56 of the block as one float4 each (a warp's load:
// 8 rows x 64 bytes, contiguous) into registers, once; a block's max and sum
// are the lane's 8 rows in order, then a __shfl_xor_sync tree over the row
// lanes (4, 8, 16), in a fixed order -- no round trip through shared memory
// for the reduction.  ``combined``'s only dependency across warps is
// acc[0, 0], which warp 0 writes to one of two shared words after a pass:
// one named barrier a pass (none after the last), which warp 0 only arrives
// at and the other warps wait on, where the first design took four full
// barriers; the max tree runs once (a max of x + c is the max of x, plus c)
// and the exp is ex2's (__expf) on the rows below the length only.
// baseline's four block results meet in shared memory behind one barrier.
// The empty kernel beside it, launched the same way (probe_empty), is the
// launch floor the smoke reads.
#include <cuda_runtime.h>

#include <cmath>

constexpr int P2_B = 4, P2_BLOCK = 64, P2_H = 16;

enum { P2_BASELINE = 0, P2_REDUCE3D = 1, P2_BCASTCMP = 2, P2_COMBINED = 3 };

constexpr int P2_WARPS = P2_B;               // warp b reduces block b
constexpr int P2_LANE_ROWS = P2_BLOCK / 8;   // a lane's rows: j + 8i, i < 8

static __device__ __forceinline__ float4 p2_max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}
static __device__ __forceinline__ float4 p2_add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
static __device__ __forceinline__ float4 p2_shfl4(float4 v, int o) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, o), __shfl_xor_sync(0xffffffffu, v.y, o),
                     __shfl_xor_sync(0xffffffffu, v.z, o), __shfl_xor_sync(0xffffffffu, v.w, o));
}
// over the 8 row lanes (lane bits 2-4): every lane ends with the same value,
// each pair of partners adding the same two numbers
static __device__ __forceinline__ float4 p2_tree_max(float4 v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v = p2_max4(v, p2_shfl4(v, o));
  return v;
}
static __device__ __forceinline__ float4 p2_tree_sum(float4 v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v = p2_add4(v, p2_shfl4(v, o));
  return v;
}

__global__ void __launch_bounds__(P2_WARPS * 32) p2_kernel(const float* __restrict__ x,
                                                           float* __restrict__ out,
                                                           int variant) {
  __shared__ float4 part[2][P2_WARPS][P2_H / 4];  // baseline: each block's max and sum
  __shared__ float a00s[2];                       // combined: acc[0, 0] after passes 0, 1
  const int lane = threadIdx.x & 31, b = threadIdx.x >> 5;
  const int q = lane & 3, j = lane >> 2;
  const int len = 10 * (b + 1);  // 10 / 20 / 30 / 40
  const float4* xb = reinterpret_cast<const float4*>(x) + (size_t)b * P2_BLOCK * (P2_H / 4) + q;
  float4 v[P2_LANE_ROWS];
#pragma unroll
  for (int i = 0; i < P2_LANE_ROWS; ++i) v[i] = xb[(j + 8 * i) * (P2_H / 4)];
  float4* o4 = reinterpret_cast<float4*>(out);

  if (variant != P2_COMBINED) {
    float4 m = v[0], s = v[0];
    if (variant == P2_BCASTCMP) {  // rows at or past the length read -1e9
      const float4 fill = make_float4(-1e9f, -1e9f, -1e9f, -1e9f);
      s = j < len ? v[0] : fill;
#pragma unroll
      for (int i = 1; i < P2_LANE_ROWS; ++i) s = p2_add4(s, j + 8 * i < len ? v[i] : fill);
      s = p2_tree_sum(s);
      if (b == 0 && j == 0) o4[q] = s;
      return;
    }
#pragma unroll
    for (int i = 1; i < P2_LANE_ROWS; ++i) {
      m = p2_max4(m, v[i]);
      s = p2_add4(s, v[i]);
    }
    m = p2_tree_max(m);
    s = p2_tree_sum(s);
    if (variant == P2_REDUCE3D) {
      if (b == 0 && j == 0) o4[q] = p2_add4(m, s);
      return;
    }
    // baseline: the four blocks' results, in block order
    if (j == 0) {
      part[0][b][q] = m;
      part[1][b][q] = s;
    }
    __syncthreads();
    if (b == 0 && j == 0) {
      float4 M = part[0][0][q], S = part[1][0][q];
#pragma unroll
      for (int w = 1; w < P2_WARPS; ++w) {
        M = p2_max4(M, part[0][w][q]);
        S = p2_add4(S, part[1][w][q]);
      }
      o4[q] = p2_add4(M, S);
    }
    return;
  }

  // combined.  acc lives in warp 0's registers (every row lane holds it);
  // the other warps take acc[0, 0] from a shared word warp 0 writes after a
  // pass, behind a named barrier of the pass that warp 0 only arrives at:
  // block 0's chain never waits for the other blocks.  A block's max of y =
  // x + acc[0, 0] is its max of x plus acc[0, 0] (rounding is monotonic), so
  // the max tree runs once; exp(y - m) is ex2 of (y - m) log2(e) (__expf,
  // a few 1e-7 relative), taken only for rows below the length.
  float4 xm = v[0];
#pragma unroll
  for (int i = 1; i < P2_LANE_ROWS; ++i) xm = p2_max4(xm, v[i]);
  xm = p2_tree_max(xm);
  const int steps = (len + 7) >> 3;  // row steps i holding a row below the length
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float a00 = 0.f;
  for (int pass = 0; pass < 3; ++pass) {
    if (pass > 0) {
      if (b == 0) {
        a00 = __shfl_sync(0xffffffffu, acc.x, 0);
      } else {
        asm volatile("bar.sync %0, %1;\n" ::"r"(pass), "r"(P2_WARPS * 32) : "memory");
        a00 = a00s[pass - 1];
      }
    }
    const float4 m = make_float4(xm.x + a00, xm.y + a00, xm.z + a00, xm.w + a00);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < P2_LANE_ROWS; ++i)
      if (i < steps && j + 8 * i < len)
        s = p2_add4(s, make_float4(__expf((v[i].x + a00) - m.x), __expf((v[i].y + a00) - m.y),
                                   __expf((v[i].z + a00) - m.z), __expf((v[i].w + a00) - m.w)));
    s = p2_tree_sum(s);
    if (b == 0) {
      acc = p2_add4(acc, s);
      if (pass < 2) {
        if (lane == 0) a00s[pass] = acc.x;
        __threadfence_block();
        asm volatile("bar.arrive %0, %1;\n" ::"r"(pass + 1), "r"(P2_WARPS * 32) : "memory");
      }
    }
  }
  if (b == 0 && j == 0) o4[q] = acc;
}

// x [256, 16] float32 (16-byte aligned) -> out [16] float32 (16-byte
// aligned) on ``stream``.  Returns the CUDA error of the launch (0 = accepted).
extern "C" int p2_mosaic_probe(const void* x, void* out, int variant, void* stream) {
  if (variant < P2_BASELINE || variant > P2_COMBINED) return (int)cudaErrorInvalidValue;
  p2_kernel<<<1, P2_WARPS * 32, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out,
                                                           variant);
  return (int)cudaGetLastError();
}

// The launch floor: a kernel that does nothing, launched as p2_mosaic_probe is
// (one block of 128 threads on ``stream``).  Returns the CUDA error of the launch.
__global__ void probe_empty_kernel() {}

extern "C" int probe_empty(void* stream) {
  probe_empty_kernel<<<1, P2_WARPS * 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
