// K3a / K3b: single-query ("flash decode") attention of the current token
// against the t2s KV cache with per-slot lengths, on Hopper (sm_90a).
//
// Replaces the TPU kernels gsv_tts_tpu/ops/flash_decode.py:
// flash_decode_attention (K3a, one layer's cache [B, S, H, Dh]) and
// flash_decode_attention_layered (K3b, layer ``layer`` of the stacked cache
// [L, B, S, H, Dh], no slice materialised).  Both share one kernel body, as
// the Pallas pair shares ``_kernel``: K3b only adds layer * B*S*H*Dh to the
// cache pointers.
//
// out[b, h] = softmax_s(q[b, h] . k[b, s, h] / sqrt(Dh)) v[b, s, h] over
// s <= kv_len[b] (the caller has already written the token's own row at
// kv_len[b]).
//
// What bounds it on the card: bytes -- 4 * sum_b (kv_len[b] + 1) * H*Dh of
// bf16 cache per call, a few MB, i.e. one or two microseconds; a launch costs
// as much, so the call is one launch.  Its first design ran a (head, 64-row
// split, slot) grid that wrote float32 partials to device memory and a second
// kernel that merged them: two launches, and at S=1024 and kv_len ~300 11 of
// every 16 blocks exited at once while the live ones walked two steps each.
//
// k3_attn: one launch, a cluster of C blocks (C in {1, 2, 4, 8}, picked on
// the host from B*H against the SMs and from S: ops/flash_decode.py
// cluster_plan) for each (slot, head); grid (C, H, B).
//   * block c of the cluster walks its share [c*chunk, (c+1)*chunk) of the
//     kv_len[b] + 1 rows with decode_common.cuh's attn_walk: 8 warps, each row
//     read by Dh/8 lanes (16 bytes each), the loads of four steps asked for
//     together; rows past kv_len[b] are never read, and a block whose share
//     is empty reads nothing;
//   * every (warp, row slot) keeps an online softmax in registers; the slots
//     of a warp merge by shuffles, the warps of a block in shared memory;
//   * the blocks of a cluster merge through distributed shared memory: after
//     a cluster barrier rank 0 reads every rank's (max, sum, Dh outputs) from
//     its shared memory and writes the output; a second barrier keeps the
//     others resident until it has.  Nothing goes through L2.  C=1 (from
//     5 slots on at H=16, where twice the blocks would no longer fit the
//     SMs at once) launches without the cluster attribute and skips both
//     barriers;
//   * every merge runs in a fixed order, so the output is deterministic and
//     K3a and K3b are bitwise equal at equal shapes.
// A kv_len outside [0, S) sets ERR_KV_LEN and yields NaN for that slot.
#include <cooperative_groups.h>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

constexpr int K3_THREADS = 256;  // 8 warps per block
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int K3_MAX_CLUSTER = 8;

static __device__ __forceinline__ float to_float(float v) { return v; }
static __device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
static __device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// The merge weight of a partial with maximum ``m`` under the joint maximum
// ``mx`` (0 for a partial that met no row).
static __device__ __forceinline__ float k3_weight(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

// q [B, H, Dh]; kc/vc: one layer's [B, S, H*Dh] cache; out [B, H, Dh].
template <int LPR, typename QT, bool CLUSTER>
__global__ void __launch_bounds__(K3_THREADS)
k3_attn(const QT* __restrict__ q, const bf16* __restrict__ kc, const bf16* __restrict__ vc,
        const int* __restrict__ kv_len, int S, float scale, QT* __restrict__ out,
        int* __restrict__ err) {
  constexpr int Dh = LPR * 8;
  __shared__ float s_m[K3_WARPS], s_l[K3_WARPS];
  __shared__ float s_acc[K3_WARPS * Dh];
  __shared__ float s_part[Dh + 2];  // the block's (max, sum, outputs), read by rank 0
  const int C = gridDim.x, rank = blockIdx.x;  // the cluster spans grid dimension x
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int D = H * Dh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  QT* ob = out + ((size_t)b * H + h) * Dh;
  const int kv = kv_len[b];
  if (kv < 0 || kv >= S) {  // uniform over the cluster: no block reaches a barrier
    if (tid == 0 && h == 0 && rank == 0) atomicOr(err, ERR_KV_LEN);
    if (rank == 0 && tid < Dh) store(ob + tid, nanf(""));
    return;
  }
  const int n = kv + 1;
  const int chunk = (n + C - 1) / C;
  const int s_begin = min(n, rank * chunk), s_end = min(n, s_begin + chunk);
  const size_t hoff = (size_t)h * Dh;
  const int d0 = (lane % LPR) * 8;
  float qr[8], none[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    qr[j] = to_float(q[(size_t)b * D + hoff + d0 + j]);
    none[j] = 0.f;
  }
  float m, l, acc[8];
  attn_walk<LPR, K3_THREADS>(qr, none, none, false, kc + (size_t)b * S * D + hoff,
                             vc + (size_t)b * S * D + hoff, D, n, s_begin, s_end, scale, tid, m,
                             l, acc);
  // the warp's row slots (lanes that share lane % LPR hold the same dims)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, o);
    const float mx = fmaxf(m, m_o);
    const float c = k3_weight(m, mx), c_o = k3_weight(m_o, mx);
    l = l * c + l_o * c_o;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = acc[j] * c + __shfl_xor_sync(0xffffffffu, acc[j], o) * c_o;
    m = mx;
  }
  if (lane < LPR) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s_acc[warp * Dh + d0 + j] = acc[j];
    if (lane == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();
  // the block's warps, in order
  if (tid < Dh) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < K3_WARPS; ++w) mx = fmaxf(mx, s_m[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < K3_WARPS; ++w) {
      const float c = k3_weight(s_m[w], mx);
      lsum += s_l[w] * c;
      a += s_acc[w * Dh + tid] * c;
    }
    if constexpr (!CLUSTER) {
      store(ob + tid, a / lsum);
    } else {
      s_part[2 + tid] = a;
      if (tid == 0) {
        s_part[0] = mx;
        s_part[1] = lsum;
      }
    }
  }
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's partial is in its shared memory
    if (rank == 0 && tid < Dh) {
      // the cluster's blocks, in rank order; all remote reads asked for at once
      float mr[K3_MAX_CLUSTER], lr[K3_MAX_CLUSTER], ar[K3_MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < K3_MAX_CLUSTER; ++r) {
        mr[r] = -INFINITY;
        lr[r] = ar[r] = 0.f;
        if (r < C) {
          const float* p = cluster.map_shared_rank(&s_part[0], r);
          mr[r] = p[0];
          lr[r] = p[1];
          ar[r] = p[2 + tid];
        }
      }
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < K3_MAX_CLUSTER; ++r) mx = fmaxf(mx, mr[r]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int r = 0; r < K3_MAX_CLUSTER; ++r) {
        const float c = k3_weight(mr[r], mx);
        lsum += lr[r] * c;
        a += ar[r] * c;
      }
      store(ob + tid, a / lsum);
    }
    cluster.sync();  // no block leaves while rank 0 may still read its shared memory
  }
}

template <int LPR, typename QT>
static int launch_one(const QT* q, const bf16* kc, const bf16* vc, const int* kv_len, QT* out,
                      int* err, int B, int S, int H, int C, cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)(LPR * 8));
  if (C == 1) {
    k3_attn<LPR, QT, false><<<dim3(1, H, B), K3_THREADS, 0, st>>>(q, kc, vc, kv_len, S, scale,
                                                                   out, err);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, H, B);
  cfg.blockDim = dim3(K3_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, k3_attn<LPR, QT, true>, q, kc, vc, kv_len, S, scale, out, err);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename QT>
static int launch(const QT* q, const bf16* kc, const bf16* vc, const int* kv_len, QT* out,
                  int* err, int B, int S, int H, int Dh, int C, cudaStream_t st) {
  if (C != 1 && C != 2 && C != 4 && C != K3_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 8: return launch_one<1, QT>(q, kc, vc, kv_len, out, err, B, S, H, C, st);
    case 16: return launch_one<2, QT>(q, kc, vc, kv_len, out, err, B, S, H, C, st);
    case 32: return launch_one<4, QT>(q, kc, vc, kv_len, out, err, B, S, H, C, st);
    case 64: return launch_one<8, QT>(q, kc, vc, kv_len, out, err, B, S, H, C, st);
    case 128: return launch_one<16, QT>(q, kc, vc, kv_len, out, err, B, S, H, C, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3b: layer ``layer`` of the stacked caches [L, B, S, H, Dh], one launch of
// clusters of C blocks.  ``q_f32``: q and out are float32 (else bf16).
// Returns the CUDA error of the launch (0 = accepted).
extern "C" int k3b_flash_decode_layered(const void* q, const void* k_cache, const void* v_cache,
                                        const int* kv_len, void* out, int* err, int layer, int B,
                                        int S, int H, int Dh, int q_f32, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t off = (size_t)layer * B * S * H * Dh;
  const bf16* kc = (const bf16*)k_cache + off;
  const bf16* vc = (const bf16*)v_cache + off;
  if (q_f32)
    return launch<float>((const float*)q, kc, vc, kv_len, (float*)out, err, B, S, H, Dh, C, st);
  return launch<bf16>((const bf16*)q, kc, vc, kv_len, (bf16*)out, err, B, S, H, Dh, C, st);
}

// K3a: one layer's caches [B, S, H, Dh].
extern "C" int k3a_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                                const int* kv_len, void* out, int* err, int B, int S, int H,
                                int Dh, int q_f32, int C, void* stream) {
  return k3b_flash_decode_layered(q, k_cache, v_cache, kv_len, out, err, 0, B, S, H, Dh, q_f32,
                                  C, stream);
}
