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
// The layer itself (GEMV, attention with the append, LayerNorm) is
// decode_common.cuh's decode_layer_rows, shared with K5 and K6; this file
// adds the embedding, the head and the sampling around it.  Like K1 it pays
// one launch per GEMV/attention/LayerNorm (8 per layer); a persistent fused
// kernel and CUDA-graph capture are later work.
#define DEC_WITH_ROWS
#include "decode_common.cuh"

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
extern "C" int k2_decode_step_batched(const K2Args* a, const LayerWeights* layers,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int B = a->B, D = a->D, M = a->M, V = a->V, S = a->S;
  int rc;
  if (B < 1 || B > ROWS_MAX_B) return (int)cudaErrorInvalidValue;

  k2_embed<<<B, 256, 0, st>>>(a->audio_emb, a->pe, a->alpha, a->last_tok, a->kv_len, a->x_len,
                              V, D, a->P, a->x, a->err);
  DEC_CHECK();
  const RowsWork ws = {a->x, a->h, a->qkv, a->attn, a->mlp, a->part, a->err};
  for (int l = 0; l < a->L; ++l) {
    if ((rc = decode_layer_rows(B, D, a->H, M, S, a->attn_scale, layers[l],
                                a->k_cache + (size_t)l * B * S * D,
                                a->v_cache + (size_t)l * B * S * D, a->kv_len, ws, st)))
      return rc;
  }
  if ((rc = launch_rows_gemv(B, a->predict_w, nullptr, a->x, nullptr, a->row_out, V, D, 0,
                             st)))
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
