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
// bf16 cache per call, a few MB, i.e. microseconds; the launch floor is of
// the same order.  The design is the split-KV walk of decode_common.cuh on a
// (head, split, slot) grid of 64-row splits: every block reads its slot's
// kv_len from the device array and exits when its split starts past it, so
// cache rows past kv_len[b] are never read -- the property the TPU kernel
// gets from clamping its block index map.  The float32 partials (max, sum,
// output) go to a workspace the wrapper allocates and a second small kernel
// merges them.  A kv_len outside [0, S) sets ERR_KV_LEN and yields NaN.
#include "decode_common.cuh"

static __device__ __forceinline__ float to_float(float v) { return v; }
static __device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
static __device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// q [B, H, Dh]; kc/vc: one layer's [B, S, H*Dh] cache.
template <int LPR, typename QT>
__global__ void __launch_bounds__(ATTN_THREADS)
k3_attn_partial(const QT* __restrict__ q, const bf16* __restrict__ kc,
                const bf16* __restrict__ vc, const int* __restrict__ kv_len, int S, float scale,
                float* __restrict__ part, int nsplit_max, int* __restrict__ err) {
  constexpr int Dh = LPR * 8;
  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z, H = gridDim.x;
  const int D = H * Dh;
  const int kv = kv_len[b];
  if (kv < 0 || kv >= S) {  // uniform over the block
    if (threadIdx.x == 0 && h == 0 && split == 0) atomicOr(err, ERR_KV_LEN);
    return;
  }
  if (split * ATTN_ROWS > kv) return;
  const size_t hoff = (size_t)h * Dh;
  const int d0 = (threadIdx.x & 31) % LPR * 8;
  float qr[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qr[j] = to_float(q[(size_t)b * D + hoff + d0 + j]);
  attn_split_partial<LPR>(qr, nullptr, nullptr, kc + (size_t)b * S * D + hoff,
                          vc + (size_t)b * S * D + hoff, D, kv + 1, split, scale,
                          part + (((size_t)b * H + h) * nsplit_max + split) * (Dh + 2));
}

template <typename QT>
__global__ void k3_attn_combine(const float* __restrict__ part, const int* __restrict__ kv_len,
                                int S, int nsplit_max, int Dh, QT* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int kv = kv_len[b];
  const bool ok = kv >= 0 && kv < S;
  const int nsplit = ok ? kv / ATTN_ROWS + 1 : 0;
  const float* p = part + ((size_t)b * H + h) * nsplit_max * (Dh + 2);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x)
    store(out + ((size_t)b * H + h) * Dh + d,
          ok ? attn_split_combine(p, nsplit, Dh, d) : nanf(""));
}

template <typename QT>
static int launch(const QT* q, const bf16* kc, const bf16* vc, const int* kv_len, QT* out,
                  float* part, int* err, int B, int S, int H, int Dh, cudaStream_t st) {
  const int nsplit_max = (S + ATTN_ROWS - 1) / ATTN_ROWS;
  const dim3 grid(H, nsplit_max, B);
  const float scale = 1.0f / sqrtf((float)Dh);
#define K3_ATTN(LPR)                                                                         \
  k3_attn_partial<LPR, QT><<<grid, ATTN_THREADS, 0, st>>>(q, kc, vc, kv_len, S, scale, part, \
                                                          nsplit_max, err)
  switch (Dh) {
    case 8: K3_ATTN(1); break;
    case 16: K3_ATTN(2); break;
    case 32: K3_ATTN(4); break;
    case 64: K3_ATTN(8); break;
    case 128: K3_ATTN(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef K3_ATTN
  DEC_CHECK();
  k3_attn_combine<QT><<<dim3(H, B), 128, 0, st>>>(part, kv_len, S, nsplit_max, Dh, out);
  DEC_CHECK();
  return 0;
}

// K3b: layer ``layer`` of the stacked caches [L, B, S, H, Dh].  ``q_f32``:
// q and out are float32 (else bf16).  ``part``: B * H * ceil(S/64) * (Dh+2)
// floats.  Returns the first CUDA launch error (0 = accepted).
extern "C" int k3b_flash_decode_layered(const void* q, const void* k_cache, const void* v_cache,
                                        const int* kv_len, void* out, float* part, int* err,
                                        int layer, int B, int S, int H, int Dh, int q_f32,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t off = (size_t)layer * B * S * H * Dh;
  const bf16* kc = (const bf16*)k_cache + off;
  const bf16* vc = (const bf16*)v_cache + off;
  if (q_f32)
    return launch<float>((const float*)q, kc, vc, kv_len, (float*)out, part, err, B, S, H, Dh, st);
  return launch<bf16>((const bf16*)q, kc, vc, kv_len, (bf16*)out, part, err, B, S, H, Dh, st);
}

// K3a: one layer's caches [B, S, H, Dh].
extern "C" int k3a_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                                const int* kv_len, void* out, float* part, int* err, int B,
                                int S, int H, int Dh, int q_f32, void* stream) {
  return k3b_flash_decode_layered(q, k_cache, v_cache, kv_len, out, part, err, 0, B, S, H, Dh,
                                  q_f32, stream);
}
