// K1: the whole B=1 t2s decode step on Hopper (sm_90a), as a chain of
// hand-written kernels launched from one host entry point.
//
// Replaces the TPU kernel gsv_tts_tpu/ops/fused_step.py:_kernel_sample
// (wrapper fused_decode_step_sample): embedding + positional entry, L
// post-norm layers with the K/V row appended in place, the logits head and
// the whole sampling chain (suppression, repetition penalty, top-p on the
// pre-temperature row, temperature, top-k pivot, Gumbel argmax).
//
// What bounds it on the card: the weights.  Every step reads every layer's
// matrices once, 2*L*(4*D*D + 2*D*M) bytes of bf16 -- about 151 MB at the
// flagship widths (L=24, D=512, M=2048) -- plus the head (V*D) and the
// attended cache rows, all at batch 1, so the step is a string of
// bandwidth-bound GEMVs whose floor, computed from those bytes at the
// H100's published 3.35 TB/s, is ~45 us (a bound, not a measurement).
// This first design does the simplest thing about it that is right: one
// warp per output row streams that row with 16-byte loads (coalesced,
// read exactly once), activations stay in float32 scratch of a few KB, and
// nothing else touches device memory twice.  The attention over the cache
// (the other byte stream: 2*L*kv_len*D bytes) is split into 64-row pieces
// so that every head's walk spreads over many SMs.  It pays one launch per
// GEMV/attention/LayerNorm (8 per layer) instead of fusing; a persistent
// fused kernel, wgmma/TMA and CUDA-graph capture are later work.
//
// Precision follows the TPU kernel: bf16 weights and caches, activations
// rounded to bf16 only where they enter a matrix product, float32
// accumulation, float32 LayerNorm, float32 single-query attention with an
// online softmax (this token's own K/V enter in float32, as in the TPU
// kernel), filtered row values of -1e30 for removed ids.
#include "decode_common.cuh"

typedef LayerWeights K1Layer;

struct K1Args {
  int L, D, H, M, V, S, P;
  float alpha;        // audio_pos_alpha
  float attn_scale;   // 1 / sqrt(Dh)
  const bf16* audio_emb;  // [V, D]
  const float* pe;        // [P, D]
  const bf16* predict_w;  // [V, D]
  bf16* k_cache;          // [L, S, D]  (the [L, 1, S, H, Dh] cache)
  bf16* v_cache;
  int* tok_buf;           // [S]
  const int* last_tok;    // [1]
  const float* gumbel;    // [V]
  int kv_len, pe_idx, buf_len;
  int suppress, n_suppressed;
  int suppressed[DEC_MAX_SUPPRESSED];
  int use_prev;
  float rep_penalty, top_p, inv_temperature;
  int top_k;
  float* x;     // [D]   float32 workspace
  float* h;     // [D]
  float* qkv;   // [3D]
  float* attn;  // [D]
  float* mlp;   // [M]
  float* part;  // [H, ceil((kv_len + 1) / 64), Dh + 2] attention partials
  float* row_out;  // [V]  logits, then the filtered row
  int* tok_out;    // [1]
  int* err;        // [1]  set to 1 when last_tok is out of range
};

// ---------------------------------------------------------------------------
// x = float(bf16(audio_emb[last_tok]) + bf16(alpha * pe[pe_idx]))
// ---------------------------------------------------------------------------
__global__ void k1_embed(const bf16* __restrict__ emb, const float* __restrict__ pe,
                         float alpha, const int* __restrict__ last_tok, int V, int D,
                         int pe_idx, float* __restrict__ x, int* __restrict__ err) {
  const int t = *last_tok;
  const bool ok = t >= 0 && t < V;  // bounds-checked, never clamped
  if (!ok && blockIdx.x == 0 && threadIdx.x == 0) *err = 1;
  for (int d = blockIdx.x * blockDim.x + threadIdx.x; d < D; d += gridDim.x * blockDim.x) {
    if (!ok) {
      x[d] = nanf("");
      continue;
    }
    const float e = __bfloat162float(emb[(size_t)t * D + d]);
    const float p = __bfloat162float(__float2bfloat16(alpha * pe[(size_t)pe_idx * D + d]));
    x[d] = __bfloat162float(__float2bfloat16(e + p));
  }
}

// ---------------------------------------------------------------------------
// y[n] = (res[n] +) sum_k bf16(x[k]) * W[n, k] (+ bias[n]) (relu), float32.
// One warp per output row; each lane streams 16 bytes (8 bf16) at a time.
// Requires K % 8 == 0 and 16-byte aligned rows (checked by the caller).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(GEMV_WARPS * 32)
k1_gemv(const bf16* __restrict__ W, const bf16* __restrict__ bias,
        const float* __restrict__ x, const float* __restrict__ res,
        float* __restrict__ y, int N, int K, int relu) {
  extern __shared__ float xs[];
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    xs[k] = __bfloat162float(__float2bfloat16(x[k]));
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + (threadIdx.x >> 5);
  if (n >= N) return;
  const bf16* w = W + (size_t)n * K;
  float acc = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(w + k));
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p2[j]);
      acc = fmaf(f.x, xs[k + 2 * j], acc);
      acc = fmaf(f.y, xs[k + 2 * j + 1], acc);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    float v = acc;
    if (res) v = res[n] + v;
    if (bias) v += __bfloat162float(bias[n]);
    if (relu) v = fmaxf(v, 0.f);
    y[n] = v;
  }
}

// ---------------------------------------------------------------------------
// Single-query attention, split over the cache (decode_common.cuh): block
// (head h, split j) covers rows [64 j, 64 j + 64) of [0, kv_len] -- cache
// rows below kv_len plus the token itself, whose K/V enter in float32 from
// qkv.  Split 0 also appends the token's K/V row at kv_len (never read
// here, so no race).
// ---------------------------------------------------------------------------
template <int LPR>
__global__ void __launch_bounds__(ATTN_THREADS)
k1_attn_partial(const float* __restrict__ qkv, bf16* __restrict__ kc, bf16* __restrict__ vc,
                int D, int kv_len, float scale, float* __restrict__ part, int nsplit) {
  constexpr int Dh = LPR * 8;
  const int h = blockIdx.x, split = blockIdx.y;
  const size_t hoff = (size_t)h * Dh;
  const float* q = qkv + hoff;
  const float* kn = qkv + D + hoff;
  const float* vn = qkv + 2 * D + hoff;
  if (split == 0) {
    for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
      kc[(size_t)kv_len * D + hoff + d] = __float2bfloat16(kn[d]);
      vc[(size_t)kv_len * D + hoff + d] = __float2bfloat16(vn[d]);
    }
  }
  const int d0 = (threadIdx.x & 31) % LPR * 8;
  float qr[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qr[j] = q[d0 + j];
  attn_split_partial<LPR>(qr, kn, vn, kc + hoff, vc + hoff, D, kv_len, split, scale,
                          part + ((size_t)h * nsplit + split) * (Dh + 2));
}

// Merge the splits' partials of head blockIdx.x into out[h*Dh : (h+1)*Dh].
__global__ void k1_attn_combine(const float* __restrict__ part, int nsplit, int Dh,
                                float* __restrict__ out) {
  const float* p = part + (size_t)blockIdx.x * nsplit * (Dh + 2);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x)
    out[(size_t)blockIdx.x * Dh + d] = attn_split_combine(p, nsplit, Dh, d);
}

// Sampling of the one row (decode_common.cuh: sample_row).
__global__ void __launch_bounds__(SAMPLE_THREADS)
k1_sample(SampleParams p, float* row, const float* gumbel, int* tok_buf, int* tok_out,
          int buf_len, int suppress) {
  sample_row(p, row, gumbel, tok_buf, tok_out, buf_len, suppress != 0);
}

// ---------------------------------------------------------------------------
// Host entry point: the whole step, launched on ``stream``.  Returns the
// first CUDA error raised by a launch (0 when every launch was accepted).
// ---------------------------------------------------------------------------
static int launch_gemv(const bf16* W, const bf16* bias, const float* x, const float* res,
                       float* y, int N, int K, int relu, cudaStream_t st) {
  const int blocks = (N + GEMV_WARPS - 1) / GEMV_WARPS;
  k1_gemv<<<blocks, GEMV_WARPS * 32, sizeof(float) * K, st>>>(W, bias, x, res, y, N, K, relu);
  DEC_CHECK();
  return 0;
}

static int launch_attention(const float* qkv, bf16* kc, bf16* vc, int D, int H, int Dh,
                            int kv_len, float scale, float* part, float* out, cudaStream_t st) {
  const int nsplit = (kv_len + 1 + ATTN_ROWS - 1) / ATTN_ROWS;
  const dim3 grid(H, nsplit);
  switch (Dh) {
    case 8: k1_attn_partial<1><<<grid, ATTN_THREADS, 0, st>>>(qkv, kc, vc, D, kv_len, scale, part, nsplit); break;
    case 16: k1_attn_partial<2><<<grid, ATTN_THREADS, 0, st>>>(qkv, kc, vc, D, kv_len, scale, part, nsplit); break;
    case 32: k1_attn_partial<4><<<grid, ATTN_THREADS, 0, st>>>(qkv, kc, vc, D, kv_len, scale, part, nsplit); break;
    case 64: k1_attn_partial<8><<<grid, ATTN_THREADS, 0, st>>>(qkv, kc, vc, D, kv_len, scale, part, nsplit); break;
    case 128: k1_attn_partial<16><<<grid, ATTN_THREADS, 0, st>>>(qkv, kc, vc, D, kv_len, scale, part, nsplit); break;
    default: return (int)cudaErrorInvalidValue;
  }
  DEC_CHECK();
  k1_attn_combine<<<H, 128, 0, st>>>(part, nsplit, Dh, out);
  DEC_CHECK();
  return 0;
}

extern "C" int k1_decode_step(const K1Args* a, const K1Layer* layers, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int D = a->D, M = a->M, V = a->V, S = a->S;
  const int Dh = D / a->H;
  int rc;

  k1_embed<<<(D + 255) / 256, 256, 0, st>>>(a->audio_emb, a->pe, a->alpha, a->last_tok, V, D,
                                            a->pe_idx, a->x, a->err);
  DEC_CHECK();
  for (int l = 0; l < a->L; ++l) {
    const K1Layer& w = layers[l];
    bf16* kc = a->k_cache + (size_t)l * S * D;
    bf16* vc = a->v_cache + (size_t)l * S * D;
    if ((rc = launch_gemv(w.qkv_w, w.qkv_b, a->x, nullptr, a->qkv, 3 * D, D, 0, st))) return rc;
    if ((rc = launch_attention(a->qkv, kc, vc, D, a->H, Dh, a->kv_len, a->attn_scale,
                               a->part, a->attn, st))) return rc;
    if ((rc = launch_gemv(w.out_w, w.out_b, a->attn, a->x, a->h, D, D, 0, st))) return rc;
    layernorm_rows<<<1, LN_THREADS, 0, st>>>(a->h, w.ln1_g, w.ln1_b, a->h, D, 1e-5f);
    DEC_CHECK();
    if ((rc = launch_gemv(w.mlp1_w, w.mlp1_b, a->h, nullptr, a->mlp, M, D, 1, st))) return rc;
    if ((rc = launch_gemv(w.mlp2_w, w.mlp2_b, a->mlp, a->h, a->x, D, M, 0, st))) return rc;
    layernorm_rows<<<1, LN_THREADS, 0, st>>>(a->x, w.ln2_g, w.ln2_b, a->x, D, 1e-5f);
    DEC_CHECK();
  }
  if ((rc = launch_gemv(a->predict_w, nullptr, a->x, nullptr, a->row_out, V, D, 0, st))) return rc;

  SampleParams s;
  s.V = V;
  s.NP = next_pow2(V);
  s.S = S;
  s.n_suppressed = a->n_suppressed;
  for (int i = 0; i < DEC_MAX_SUPPRESSED; ++i) s.suppressed[i] = a->suppressed[i];
  s.use_prev = a->use_prev;
  s.rep_penalty = a->rep_penalty;
  s.top_p = a->top_p;
  s.inv_temperature = a->inv_temperature;
  s.top_k = a->top_k;
  k1_sample<<<1, SAMPLE_THREADS, sample_smem_bytes(V, s.NP), st>>>(
      s, a->row_out, a->gumbel, a->tok_buf, a->tok_out, a->buf_len, a->suppress);
  DEC_CHECK();
  return 0;
}
