// P3: the weight-streaming probe on Hopper (sm_90a): how fast this card
// streams a decode step's pages with trivial compute, through the port's own
// copy mechanism and through plain loads.
//
// Replaces the TPU probe tools/stream_probe.py: _make_fori (its pallas_call
// at :99; variants fori, fori256, fori1024, fori2048) and the grid variant of
// _make_step (:140).  w [pages, rows, W] bf16 (at the probe's size [24, 512,
// 6144] seen as pages of ``rows`` rows: 150,994,944 bytes a step) and x
// [rows] bf16 give y = sum over pages p of x @ w_p over all W columns, and
// every variant writes out [2, rows] float32:
//
//   out[0, c] = y[c]                                  the TPU kernels' step:
//                                                     sum_p x @ w_p[:, :rows]
//   out[1, c] = sum over m < W / rows of y[m * rows + c]    the TPU tool's xla
//                                                     step (rows = D there)
//
// so the result depends on every byte of w: the bytes are what the function
// needs, 150,994,944 / 3.35 TB/s = 0.0451 ms a step; its arithmetic (2 *
// pages * rows * W = 151 MFLOP, float32 on the CUDA cores) is 2.3 us at 67
// TFLOP/s.
//
// * p3_ring_kernel (fori<rows>, k1ring): the persistent decode kernel's
//   mechanism (bulk_copy.cuh, as decode_step_persistent.cuh streams K1's
//   weights) and nothing else.  One block per SM (the wrapper passes the SM
//   count); block i owns the rows [i * rows / blocks, (i + 1) * rows / blocks)
//   of every page.  Those rows are one contiguous run (each row is W * 2
//   bytes, a multiple of 16), cut into copies of at most ``chunk_rows`` whole
//   rows, each a 1-D bulk asynchronous copy into one slot of a ring of
//   ``stages`` slots, its completion counted on the slot's mbarrier.  One
//   thread (the last) keeps ``stages`` copies in flight: it issues the copy
//   of chunk i + stages as soon as every thread has consumed chunk i, as
//   K1's loader does.  A thread owns the 4-column groups 4 t + 2048 j of y
//   and adds x[k] times its groups of every row of the chunk (one 8-byte
//   shared-memory load a group).  The wrapper's plans: fori<rows>, two slots,
//   a block's share of a page in as few copies as two slots hold (one,
//   except at 2048 rows, where 16 rows of 12,288 bytes do not fit twice in
//   227 KB); k1ring, K1's own ring: 8 slots, each copy the whole rows that
//   fit K1's 16 KB stage (one 12,288-byte row here).
// * p3_grid_kernel (grid): the contrast, no asynchronous copy.  A plain grid
//   of (row tiles, layers) blocks, each loading its P3_TILE rows of one layer
//   with 16-byte loads; occupancy is all that overlaps the loads.  The TPU's
//   grid variant carries its sum across sequential grid steps; here the
//   blocks run at once and each writes a partial.
// * A block folds its own y (in shared memory) into its two partial rows;
//   p3_reduce_kernel sums the blocks' partials in a fixed order (the result
//   does not depend on timing) into out.  A step is two launches.
#include <cuda_bf16.h>

#include "probe_common.cuh"

typedef __nv_bfloat16 bf16;

constexpr int P3_THREADS = 512;
constexpr int P3_MAX_GROUPS = 4;     // 4-column groups of y a ring thread owns: W <= 8192
constexpr int P3_MAX_STAGES = 8;
constexpr int P3_RING_HEAD = 128;    // the mbarriers, then the ring (16-byte aligned)
constexpr int P3_GRID_THREADS = 256;
constexpr int P3_GRID_VECS = 4;      // 16-byte vectors of a row a grid thread owns: W <= 8192
constexpr int P3_TILE = 32;          // rows of one layer a grid block loads
constexpr int P3_RED_WARPS = 8;

// Dynamic shared memory of the ring: [mbarriers | pad] [the slots, later the
// block's y as float: the larger] [the block's x as float: ``share`` at most].
static __host__ __device__ inline size_t p3_ring_bytes(int stages, int chunk_rows, int W) {
  const size_t ring = (size_t)stages * chunk_rows * W * 2, ys = 4 * (size_t)W;
  return ring > ys ? ring : ys;
}

// The block's y [W] in ``ys`` -> its partial [2, rows]: y[:rows] and y folded.
static __device__ __forceinline__ void p3_fold(const float* ys, float* dst, int rows, int W,
                                               int threads) {
  for (int c = threadIdx.x; c < rows; c += threads) {
    float f = 0.f;
    for (int m = 0; m < W / rows; ++m) f += ys[m * rows + c];
    dst[c] = ys[c];
    dst[rows + c] = f;
  }
}

__global__ void __launch_bounds__(P3_THREADS, 1)
    p3_ring_kernel(const bf16* __restrict__ w, const bf16* __restrict__ x,
                   float* __restrict__ partial, int* err, int pages, int rows, int W,
                   int stages, int chunk_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* ring = smem + P3_RING_HEAD;
  float* xs = reinterpret_cast<float*>(ring + p3_ring_bytes(stages, chunk_rows, W));
  const int tid = threadIdx.x;
  const bool loader = tid == P3_THREADS - 1;
  const int r0 = (int)((long long)blockIdx.x * rows / gridDim.x);
  const int r1 = (int)((long long)(blockIdx.x + 1) * rows / gridDim.x);
  const int n = r1 - r0;  // the block's rows of a page
  const size_t row_bytes = 2 * (size_t)W, slot_bytes = chunk_rows * row_bytes;
  const int per_page = (n + chunk_rows - 1) / chunk_rows;  // copies a page
  const int total = pages * per_page;

  if (tid == 0) mbar_init(full, stages);
  for (int i = tid; i < n; i += P3_THREADS) xs[i] = __bfloat162float(x[r0 + i]);
  __syncthreads();

  // chunk i: rows [r0 + a, r0 + a + c) of page i / per_page, into slot i % stages
  auto issue = [&](int i) {
    const int a = (i % per_page) * chunk_rows, c = min(chunk_rows, n - a);
    bulk_load(ring + (size_t)(i % stages) * slot_bytes,
              w + ((size_t)(i / per_page) * rows + r0 + a) * W, (uint32_t)(c * row_bytes),
              &full[i % stages]);
  };
  if (loader)
    for (int i = 0; i < stages && i < total; ++i) issue(i);

  float acc[P3_MAX_GROUPS][4];
#pragma unroll
  for (int j = 0; j < P3_MAX_GROUPS; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int i = 0; i < total; ++i) {
    const int st = i % stages;
    probe_wait(&full[st], (uint32_t)((i / stages) & 1), err);
    const unsigned char* slot = ring + (size_t)st * slot_bytes;
    const int a = (i % per_page) * chunk_rows, c = min(chunk_rows, n - a);
    for (int k = 0; k < c; ++k) {
      const float xv = xs[a + k];
      const uint2* row = reinterpret_cast<const uint2*>(slot + (size_t)k * row_bytes);
#pragma unroll
      for (int j = 0; j < P3_MAX_GROUPS; ++j) {
        const int g = tid + P3_THREADS * j;  // columns 4 g .. 4 g + 3
        if (4 * g < W) {
          const uint2 v = row[g];
          const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
          const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
          acc[j][0] = fmaf(xv, f0.x, acc[j][0]);
          acc[j][1] = fmaf(xv, f0.y, acc[j][1]);
          acc[j][2] = fmaf(xv, f1.x, acc[j][2]);
          acc[j][3] = fmaf(xv, f1.y, acc[j][3]);
        }
      }
    }
    __syncthreads();  // every thread is done with slot st
    if (loader && i + stages < total) issue(i + stages);
  }

  // every copy has been waited for: the ring holds the block's y
  float* ys = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < P3_MAX_GROUPS; ++j) {
    const int g = tid + P3_THREADS * j;
    if (4 * g < W)
      *reinterpret_cast<float4*>(ys + 4 * g) = make_float4(acc[j][0], acc[j][1], acc[j][2],
                                                           acc[j][3]);
  }
  __syncthreads();
  p3_fold(ys, partial + (size_t)blockIdx.x * 2 * rows, rows, W, P3_THREADS);
}

// block (tile, layer): rows [tile * P3_TILE, + P3_TILE) of layer ``layer``, every column
__global__ void __launch_bounds__(P3_GRID_THREADS)
    p3_grid_kernel(const bf16* __restrict__ w, const bf16* __restrict__ x,
                   float* __restrict__ partial, int D, int W) {
  extern __shared__ __align__(16) float ys[];  // [W]
  __shared__ float xs[P3_TILE];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * P3_TILE, layer = blockIdx.y;
  const int vec_row = W / 8;  // 16-byte vectors a row
  const uint4* src = reinterpret_cast<const uint4*>(w + ((size_t)layer * D + k0) * W);
  if (tid < P3_TILE) xs[tid] = __bfloat162float(x[k0 + tid]);
  __syncthreads();
  float acc[P3_GRID_VECS][8];
#pragma unroll
  for (int m = 0; m < P3_GRID_VECS; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
  // thread t takes vectors t, t + 256, ... (columns 8 g .. 8 g + 7) of every row
#pragma unroll 4
  for (int k = 0; k < P3_TILE; ++k) {
    const uint4* row = src + (size_t)k * vec_row;
    const float xv = xs[k];
#pragma unroll
    for (int m = 0; m < P3_GRID_VECS; ++m) {
      const int g = tid + m * P3_GRID_THREADS;
      if (g < vec_row) {
        const uint4 v = __ldg(row + g);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          acc[m][2 * j] = fmaf(xv, f.x, acc[m][2 * j]);
          acc[m][2 * j + 1] = fmaf(xv, f.y, acc[m][2 * j + 1]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < P3_GRID_VECS; ++m) {
    const int g = tid + m * P3_GRID_THREADS;
    if (g < vec_row) {
      float4* dst = reinterpret_cast<float4*>(ys + 8 * g);
      dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
  __syncthreads();
  p3_fold(ys, partial + ((size_t)layer * gridDim.x + blockIdx.x) * 2 * D, D, W, P3_GRID_THREADS);
}

// out[c] = the sum over b of partial[b, c], b in order: warp v adds b = v, v + 8, ...
__global__ void __launch_bounds__(32 * P3_RED_WARPS)
    p3_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int blocks,
                     int cols) {
  __shared__ float red[P3_RED_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < cols)
    for (int b = warp; b < blocks; b += P3_RED_WARPS) s += partial[(size_t)b * cols + col];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float t = 0.f;
    for (int v = 0; v < P3_RED_WARPS; ++v) t += red[v][lane];
    out[col] = t;
  }
}

static int p3_reduce(const float* partial, float* out, int blocks, int cols, cudaStream_t st) {
  p3_reduce_kernel<<<(cols + 31) / 32, 32 * P3_RED_WARPS, 0, st>>>(partial, out, blocks, cols);
  return (int)cudaGetLastError();
}

// fori<rows>, k1ring: w [pages, rows, W] bf16, x [rows] bf16 -> out [2, rows]
// float32 through ``blocks`` resident blocks (one an SM), copies of at most
// ``chunk_rows`` rows through ``stages`` slots; partial [blocks, 2, rows]
// float32 is scratch.  Returns the CUDA error of the launches (0 = accepted).
extern "C" int p3_stream_ring(const void* w, const void* x, void* partial, void* out, int* err,
                              int pages, int rows, int W, int stages, int chunk_rows, int blocks,
                              void* stream) {
  static unsigned long long smem_set = 0;
  if (pages < 1 || rows < 1 || W % 8 != 0 || W < rows || W % rows != 0 ||
      W > 4 * P3_THREADS * P3_MAX_GROUPS || stages < 1 || stages > P3_MAX_STAGES ||
      chunk_rows < 1 || (size_t)chunk_rows * W * 2 >= (1u << 20) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = P3_RING_HEAD + p3_ring_bytes(stages, chunk_rows, W) +
                      4 * (size_t)((rows + blocks - 1) / blocks);
  if (smem > SMEM_OPTIN) return (int)cudaErrorInvalidValue;
  int rc = probe_allow_smem((const void*)p3_ring_kernel, &smem_set);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  p3_ring_kernel<<<blocks, P3_THREADS, smem, st>>>((const bf16*)w, (const bf16*)x,
                                                   (float*)partial, err, pages, rows, W, stages,
                                                   chunk_rows);
  if ((rc = (int)cudaGetLastError())) return rc;
  return p3_reduce((const float*)partial, (float*)out, blocks, 2 * rows, st);
}

// grid: w [L, D, W] bf16, x [D] bf16 -> out [2, D] float32; partial
// [L * D / P3_TILE, 2, D] float32 is scratch.  Returns the CUDA error of the
// launches (0 = accepted).
extern "C" int p3_stream_grid(const void* w, const void* x, void* partial, void* out, int L,
                              int D, int W, void* stream) {
  if (L < 1 || D < P3_TILE || D % P3_TILE != 0 || W % 8 != 0 || W < D || W % D != 0 ||
      W > 8 * P3_GRID_THREADS * P3_GRID_VECS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  p3_grid_kernel<<<dim3(D / P3_TILE, L), P3_GRID_THREADS, 4 * (size_t)W, st>>>(
      (const bf16*)w, (const bf16*)x, (float*)partial, D, W);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return p3_reduce((const float*)partial, (float*)out, L * (D / P3_TILE), 2 * D, st);
}
