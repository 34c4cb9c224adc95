// K2: the whole t2s decode step for a wave of B cache slots on Hopper
// (sm_90a), as a chain of hand-written kernels launched from one host entry
// point.
//
// Replaces the TPU kernel gsv_tts_tpu/ops/fused_step.py:_kernel_sample_b
// (wrapper fused_decode_step_sample_batched): per-slot embedding +
// positional entry (clamped at 0 for a frozen slot, whose kv_len < x_len),
// L post-norm layers with each slot's K/V row appended in place at its own
// kv_len[b], per-slot single-query attention over [0, kv_len[b]] including
// the new row, the logits head and the per-row sampling chain.
//
// What bounds it on the card: bytes.  A step reads every layer's matrices,
// 2*L*(4*D*D + 2*D*M) + 2*V*D bytes of bf16 (about 152 MB at L=24, D=512,
// M=2048, V=1025), plus each slot's attended cache rows, 4*L*kv_len[b]*D
// bytes.  At B <= 8 the products do at most 2*B flops per weight, far below
// the card's operations-per-byte ridge, so tensor cores would not help: the
// point of the TPU kernel -- the weight stream crosses device memory ONCE
// per step whatever B is -- is the property to keep.  The GEMV here does
// that: one warp per output row, each lane loads its 16 bytes of the weight
// row once and accumulates B dot products against the B activation rows,
// which sit in shared memory as bf16 (they are rounded to bf16 where they
// enter a product anyway, so this is exact and halves the footprint).
// Calling the B=1 kernels B times would read the weights B times, which is
// what this kernel exists to avoid.
//
// The attention runs on a (head, split, slot) grid of 64-row splits.  The
// per-slot counters stay on the device: every block reads its own slot's
// kv_len, blocks past it exit at once, and split 0 appends the slot's K/V
// row at kv_len[b].  The TPU kernel's 8-row read-modify-write windows and
// strided [B, block, D] walk buffers answer TPU DMA constraints and have no
// counterpart here.  Its three softmax modes ("rows", "vec", "shared") are
// one function in exact arithmetic -- "rows" and "vec" are bit-identical,
// "shared" trades a shared running max for fewer vector ops on the TPU --
// so one kernel computes the exact per-row online softmax.
//
// Out-of-range values are flagged, never clamped: a last_tok outside
// [0, V), a kv_len outside [0, S) or a positional index outside [0, P) sets
// a bit in ``err`` (the slot then produces NaN or skips its append), which
// the host reads where it synchronises anyway.
//
// Like K1 it pays one launch per GEMV/attention/LayerNorm (8 per layer); a
// persistent fused kernel and CUDA-graph capture are later work.
#include "decode_common.cuh"

constexpr int K2_MAX_B = 8;  // row accumulators a GEMV warp keeps

struct K2Args {
  int B, L, D, H, M, V, S, P;
  float alpha;        // audio_pos_alpha
  float attn_scale;   // 1 / sqrt(Dh)
  const bf16* audio_emb;  // [V, D]
  const float* pe;        // [P, D]
  const bf16* predict_w;  // [V, D]
  bf16* k_cache;          // [L, B, S, D]  (the [L, B, S, H, Dh] cache)
  bf16* v_cache;
  int* tok_buf;           // [B, S]
  const int* kv_len;      // [B]
  const int* x_len;       // [B]
  const int* last_tok;    // [B]
  const int* buf_len;     // [B]
  const int* step_idx;    // [B]
  const float* gumbel;    // [B, V]
  int suppress_until;     // a slot is suppressed while step_idx[b] < this
  int n_suppressed;
  int suppressed[DEC_MAX_SUPPRESSED];
  int use_prev;
  float rep_penalty, top_p, inv_temperature;
  int top_k;
  float* x;     // [B, D]   float32 workspace
  float* h;     // [B, D]
  float* qkv;   // [B, 3D]
  float* attn;  // [B, D]
  float* mlp;   // [B, M]
  float* part;  // [B, H, ceil(S / 64), Dh + 2] attention partials
  float* row_out;  // [B, V]  logits, then the filtered rows
  int* tok_out;    // [B]
  int* err;        // [1]  ERR_* bits
};

// ---------------------------------------------------------------------------
// x[b] = float(bf16(audio_emb[last_tok[b]]) + bf16(alpha * pe[pe_idx[b]])),
// pe_idx = max(kv_len - x_len, 0).  One block per slot.
// ---------------------------------------------------------------------------
__global__ void k2_embed(const bf16* __restrict__ emb, const float* __restrict__ pe,
                         float alpha, const int* __restrict__ last_tok,
                         const int* __restrict__ kv_len, const int* __restrict__ x_len,
                         int V, int D, int P, float* __restrict__ x, int* __restrict__ err) {
  const int b = blockIdx.x;
  const int t = last_tok[b];
  const int pe_idx = max(kv_len[b] - x_len[b], 0);
  const bool tok_ok = t >= 0 && t < V, pe_ok = pe_idx < P;
  if (threadIdx.x == 0 && !(tok_ok && pe_ok))
    atomicOr(err, (tok_ok ? 0 : ERR_LAST_TOK) | (pe_ok ? 0 : ERR_PE_IDX));
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    if (!(tok_ok && pe_ok)) {
      x[(size_t)b * D + d] = nanf("");
      continue;
    }
    const float e = __bfloat162float(emb[(size_t)t * D + d]);
    const float p = __bfloat162float(__float2bfloat16(alpha * pe[(size_t)pe_idx * D + d]));
    x[(size_t)b * D + d] = __bfloat162float(__float2bfloat16(e + p));
  }
}

// ---------------------------------------------------------------------------
// y[b, n] = (res[b, n] +) sum_k bf16(x[b, k]) * W[n, k] (+ bias[n]) (relu)
// for all NB rows b at once, float32.  One warp per output row n: each lane
// loads its 16 bytes (8 bf16) of W[n] once and feeds NB accumulators from
// the NB activation rows in shared memory (bf16, NB * K * 2 bytes).
// Requires K % 8 == 0 and 16-byte aligned weight rows and activations
// (checked by the caller).
// ---------------------------------------------------------------------------
template <int NB>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
k2_gemv(const bf16* __restrict__ W, const bf16* __restrict__ bias,
        const float* __restrict__ x, const float* __restrict__ res,
        float* __restrict__ y, int N, int K, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [NB, K]
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + (threadIdx.x >> 5);
  const bf16* w = W + (size_t)min(n, N - 1) * K;
  // the lane's first 16 bytes of the weight row are requested before the
  // activations are staged, so the two waits overlap
  uint4 wraw = make_uint4(0u, 0u, 0u, 0u);
  if (lane * 8 < K) wraw = __ldg(reinterpret_cast<const uint4*>(w + lane * 8));
  const float4* x4 = reinterpret_cast<const float4*>(x);
  __nv_bfloat162* xs2 = reinterpret_cast<__nv_bfloat162*>(xs);
  for (int i = threadIdx.x; i < NB * K / 4; i += blockDim.x) {
    const float4 v = x4[i];
    xs2[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    xs2[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
  __syncthreads();
  if (n >= N) return;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    float wf[8];
    bf16x8_to_float(wraw, wf);
    if (k + 32 * 8 < K) wraw = __ldg(reinterpret_cast<const uint4*>(w + k + 32 * 8));
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float xf[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(xs + (size_t)b * K + k), xf);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[b] = fmaf(wf[j], xf[j], acc[b]);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = warp_sum(acc[b]);
  if (lane == 0) {
    const float bv = bias ? __bfloat162float(bias[n]) : 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float v = acc[b];
      if (res) v = res[(size_t)b * N + n] + v;
      if (bias) v += bv;
      if (relu) v = fmaxf(v, 0.f);
      y[(size_t)b * N + n] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Per-slot single-query attention (decode_common.cuh): block (head h,
// split j, slot b) covers rows [64 j, 64 j + 64) of [0, kv_len[b]] -- cache
// rows below kv_len[b] plus the token itself, whose K/V enter in float32
// from qkv[b].  Split 0 appends the slot's K/V row at kv_len[b] (never read
// here, so no race).  Blocks whose split starts past kv_len[b] exit.
// kc/vc: this layer's [B, S, D] cache.
// ---------------------------------------------------------------------------
template <int LPR>
__global__ void __launch_bounds__(ATTN_THREADS)
k2_attn_partial(const float* __restrict__ qkv, bf16* __restrict__ kc, bf16* __restrict__ vc,
                const int* __restrict__ kv_len, int S, int D, float scale,
                float* __restrict__ part, int nsplit_max, int* __restrict__ err) {
  constexpr int Dh = LPR * 8;
  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z, H = gridDim.x;
  const int kv = kv_len[b];
  if (kv < 0 || kv >= S) {  // uniform over the block
    if (threadIdx.x == 0 && h == 0 && split == 0) atomicOr(err, ERR_KV_LEN);
    return;
  }
  if (split * ATTN_ROWS > kv) return;
  const size_t hoff = (size_t)h * Dh;
  const float* q = qkv + (size_t)b * 3 * D + hoff;
  const float* kn = q + D;
  const float* vn = q + 2 * D;
  bf16* kcb = kc + (size_t)b * S * D + hoff;
  bf16* vcb = vc + (size_t)b * S * D + hoff;
  if (split == 0) {
    for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
      kcb[(size_t)kv * D + d] = __float2bfloat16(kn[d]);
      vcb[(size_t)kv * D + d] = __float2bfloat16(vn[d]);
    }
  }
  const int d0 = (threadIdx.x & 31) % LPR * 8;
  float qr[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qr[j] = q[d0 + j];
  attn_split_partial<LPR>(qr, kn, vn, kcb, vcb, D, kv, split, scale,
                          part + (((size_t)b * H + h) * nsplit_max + split) * (Dh + 2));
}

// Merge the partials of (head blockIdx.x, slot blockIdx.y) into
// out[b, h*Dh : (h+1)*Dh]; a slot with a bad kv_len gets NaN.
__global__ void k2_attn_combine(const float* __restrict__ part, const int* __restrict__ kv_len,
                                int S, int nsplit_max, int Dh, float* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int kv = kv_len[b];
  const bool ok = kv >= 0 && kv < S;
  const int nsplit = ok ? kv / ATTN_ROWS + 1 : 0;
  const float* p = part + ((size_t)b * H + h) * nsplit_max * (Dh + 2);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x)
    out[((size_t)b * H + h) * Dh + d] = ok ? attn_split_combine(p, nsplit, Dh, d) : nanf("");
}

// Sampling, one block per row (decode_common.cuh: sample_row), with the
// row's own buf_len, suppression flag and tok_buf row.
__global__ void __launch_bounds__(SAMPLE_THREADS)
k2_sample(SampleParams p, float* rows, const float* gumbel, int* tok_buf, int* tok_out,
          const int* __restrict__ buf_len, const int* __restrict__ step_idx,
          int suppress_until) {
  const int b = blockIdx.x;
  sample_row(p, rows + (size_t)b * p.V, gumbel + (size_t)b * p.V, tok_buf + (size_t)b * p.S,
             tok_out + b, buf_len[b], step_idx[b] < suppress_until);
}

// ---------------------------------------------------------------------------
// Host entry point: the whole step, launched on ``stream``.  Returns the
// first CUDA error raised by a launch (0 when every launch was accepted).
// ---------------------------------------------------------------------------
template <int NB>
static int launch_gemv_nb(const bf16* W, const bf16* bias, const float* x, const float* res,
                          float* y, int N, int K, int relu, cudaStream_t st) {
  const int blocks = (N + GEMV_WARPS - 1) / GEMV_WARPS;
  k2_gemv<NB><<<blocks, GEMV_WARPS * 32, sizeof(bf16) * NB * K, st>>>(W, bias, x, res, y, N, K,
                                                                      relu);
  DEC_CHECK();
  return 0;
}

static int launch_gemv(int B, const bf16* W, const bf16* bias, const float* x, const float* res,
                       float* y, int N, int K, int relu, cudaStream_t st) {
  switch (B) {
    case 1: return launch_gemv_nb<1>(W, bias, x, res, y, N, K, relu, st);
    case 2: return launch_gemv_nb<2>(W, bias, x, res, y, N, K, relu, st);
    case 3: return launch_gemv_nb<3>(W, bias, x, res, y, N, K, relu, st);
    case 4: return launch_gemv_nb<4>(W, bias, x, res, y, N, K, relu, st);
    case 5: return launch_gemv_nb<5>(W, bias, x, res, y, N, K, relu, st);
    case 6: return launch_gemv_nb<6>(W, bias, x, res, y, N, K, relu, st);
    case 7: return launch_gemv_nb<7>(W, bias, x, res, y, N, K, relu, st);
    case 8: return launch_gemv_nb<8>(W, bias, x, res, y, N, K, relu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

static int launch_attention(const K2Args* a, const float* qkv, bf16* kc, bf16* vc, int Dh,
                            cudaStream_t st) {
  const int nsplit_max = (a->S + ATTN_ROWS - 1) / ATTN_ROWS;
  const dim3 grid(a->H, nsplit_max, a->B);
#define K2_ATTN(LPR)                                                                      \
  k2_attn_partial<LPR><<<grid, ATTN_THREADS, 0, st>>>(qkv, kc, vc, a->kv_len, a->S, a->D, \
                                                      a->attn_scale, a->part, nsplit_max, a->err)
  switch (Dh) {
    case 8: K2_ATTN(1); break;
    case 16: K2_ATTN(2); break;
    case 32: K2_ATTN(4); break;
    case 64: K2_ATTN(8); break;
    case 128: K2_ATTN(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2_ATTN
  DEC_CHECK();
  k2_attn_combine<<<dim3(a->H, a->B), 128, 0, st>>>(a->part, a->kv_len, a->S, nsplit_max, Dh,
                                                    a->attn);
  DEC_CHECK();
  return 0;
}

extern "C" int k2_decode_step_batched(const K2Args* a, const LayerWeights* layers,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int B = a->B, D = a->D, M = a->M, V = a->V, S = a->S;
  const int Dh = D / a->H;
  int rc;
  if (B < 1 || B > K2_MAX_B) return (int)cudaErrorInvalidValue;

  k2_embed<<<B, 256, 0, st>>>(a->audio_emb, a->pe, a->alpha, a->last_tok, a->kv_len, a->x_len,
                              V, D, a->P, a->x, a->err);
  DEC_CHECK();
  for (int l = 0; l < a->L; ++l) {
    const LayerWeights& w = layers[l];
    bf16* kc = a->k_cache + (size_t)l * B * S * D;
    bf16* vc = a->v_cache + (size_t)l * B * S * D;
    if ((rc = launch_gemv(B, w.qkv_w, w.qkv_b, a->x, nullptr, a->qkv, 3 * D, D, 0, st))) return rc;
    if ((rc = launch_attention(a, a->qkv, kc, vc, Dh, st))) return rc;
    if ((rc = launch_gemv(B, w.out_w, w.out_b, a->attn, a->x, a->h, D, D, 0, st))) return rc;
    layernorm_rows<<<B, LN_THREADS, 0, st>>>(a->h, w.ln1_g, w.ln1_b, a->h, D, 1e-5f);
    DEC_CHECK();
    if ((rc = launch_gemv(B, w.mlp1_w, w.mlp1_b, a->h, nullptr, a->mlp, M, D, 1, st))) return rc;
    if ((rc = launch_gemv(B, w.mlp2_w, w.mlp2_b, a->mlp, a->h, a->x, D, M, 0, st))) return rc;
    layernorm_rows<<<B, LN_THREADS, 0, st>>>(a->x, w.ln2_g, w.ln2_b, a->x, D, 1e-5f);
    DEC_CHECK();
  }
  if ((rc = launch_gemv(B, a->predict_w, nullptr, a->x, nullptr, a->row_out, V, D, 0, st)))
    return rc;

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
  k2_sample<<<B, SAMPLE_THREADS, sample_smem_bytes(V, s.NP), st>>>(
      s, a->row_out, a->gumbel, a->tok_buf, a->tok_out, a->buf_len, a->step_idx,
      a->suppress_until);
  DEC_CHECK();
  return 0;
}
