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
// The layer itself (GEMV, attention with the append, LayerNorm) is
// decode_common.cuh's decode_layer_rows at one row, the code K2, K5 and K6
// run; this file adds the embedding, the head and the sampling around it.
// Its kernels read kv_len on the device, so the embedding kernel copies the
// host's kv_len into a one-int word of the workspace first.
//
// Precision follows the TPU kernel: bf16 weights and caches, activations
// rounded to bf16 only where they enter a matrix product, float32
// accumulation, float32 LayerNorm, float32 single-query attention with an
// online softmax (this token's own K/V enter in float32, as in the TPU
// kernel), filtered row values of -1e30 for removed ids.
#define DEC_WITH_ROWS
#include "decode_common.cuh"

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
  float* part;  // [H, ceil(S / 64), Dh + 2] attention partials
  float* row_out;  // [V]  logits, then the filtered row
  int* tok_out;    // [1]
  int* err;        // [1]  ERR_* bits
  int* kv_word;    // [1]  receives kv_len for the layer kernels
};

// ---------------------------------------------------------------------------
// x = float(bf16(audio_emb[last_tok]) + bf16(alpha * pe[pe_idx]));
// *kv_word = kv_len
// ---------------------------------------------------------------------------
__global__ void k1_embed(const bf16* __restrict__ emb, const float* __restrict__ pe,
                         float alpha, const int* __restrict__ last_tok, int V, int D,
                         int pe_idx, int kv_len, float* __restrict__ x,
                         int* __restrict__ kv_word, int* __restrict__ err) {
  const int t = *last_tok;
  const bool ok = t >= 0 && t < V;  // bounds-checked, never clamped
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *kv_word = kv_len;
    if (!ok) atomicOr(err, ERR_LAST_TOK);
  }
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
extern "C" int k1_decode_step(const K1Args* a, const LayerWeights* layers, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int D = a->D, V = a->V, S = a->S;
  int rc;

  k1_embed<<<(D + 255) / 256, 256, 0, st>>>(a->audio_emb, a->pe, a->alpha, a->last_tok, V, D,
                                            a->pe_idx, a->kv_len, a->x, a->kv_word, a->err);
  DEC_CHECK();
  const RowsWork ws = {a->x, a->h, a->qkv, a->attn, a->mlp, a->part, a->err};
  for (int l = 0; l < a->L; ++l) {
    if ((rc = decode_layer_rows(1, D, a->H, a->M, S, a->attn_scale, layers[l],
                                a->k_cache + (size_t)l * S * D, a->v_cache + (size_t)l * S * D,
                                a->kv_word, ws, st)))
      return rc;
  }
  if ((rc = launch_rows_gemv(1, a->predict_w, nullptr, a->x, nullptr, a->row_out, V, D, 0, st)))
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
  k1_sample<<<1, SAMPLE_THREADS, sample_smem_bytes(V, s.NP), st>>>(
      s, a->row_out, a->gumbel, a->tok_buf, a->tok_out, a->buf_len, a->suppress);
  DEC_CHECK();
  return 0;
}
