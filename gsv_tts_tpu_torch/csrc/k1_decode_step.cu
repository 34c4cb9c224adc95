// K1: the whole B=1 t2s decode step on Hopper (sm_90a): one persistent
// cooperative kernel for the model (decode_step_persistent.cuh at one row)
// and one launch for the sampling chain.
//
// Replaces the TPU kernel gsv_tts_tpu/ops/fused_step.py:_kernel_sample
// (wrapper fused_decode_step_sample): embedding + positional entry, L
// post-norm layers with the K/V row appended in place, the logits head and
// the whole sampling chain (suppression, repetition penalty, top-p on the
// pre-temperature row, temperature, top-k pivot, Gumbel argmax).
//
// What bounds it on the card: the weights.  Every step reads every layer's
// matrices once, 2*L*(4*D*D + 2*D*M) bytes of bf16 -- 151 MB at the flagship
// widths (L=24, D=512, M=2048) -- plus the head (V*D) and the attended cache
// rows, all at one row: bytes, at 1-2 flops each.  The first version of
// this kernel was a chain of 195 launches a step (8 a layer) and took as
// long as the host needed to issue them.  decode_step_persistent.cuh says
// what the one-launch design does about that: a ring of bulk asynchronous
// copies that keeps the weight stream running through every phase, values
// that carry their own arrival tags from phase to phase instead of launches
// or barriers, LayerNorm folded into the staging of the product that reads
// it, attention merged inside one block per head, split-K where a block has
// fewer rows than warps.  What is left of a step is the chain of dependent
// trips to L2 between its 121 phases, not bytes (PERF.md).
//
// k1_decode_step_quant runs the same step on the int8 or int4 weight
// stream of the TPU kernel's quant / quant4 modes (decode_step_persistent.cuh
// says how); the sampling launch is the same.
//
// Precision follows the TPU kernel: bf16 weights and caches, activations
// rounded to bf16 only where they enter a matrix product, float32
// accumulation, float32 LayerNorm, float32 single-query attention with an
// online softmax (this token's own K/V enter in float32, as in the TPU
// kernel), filtered row values of -1e30 for removed ids.
#include "decode_step_persistent.cuh"

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
  float* x;        // [D]  the last layer's normalised row
  float* trace;    // a traced build's clock marks (PS_TRACE_BYTES)
  float* row_out;  // [V]  logits, then the filtered row
  int* tok_out;    // [1]
  int* err;        // [1]  ERR_* bits
  // what the persistent kernel reads besides (both whole-step structs carry
  // all of it; K1 hands over through ``tagged``, K2 through ``pre`` and ``bar``)
  const LayerWeights* layers_dev;  // [L] the layer table on the device
  PsTagged* tagged;                // [D | D | 3D | D | M]: one row's h, pre, qkv, attn, mlp
  float* pre;                      // [B, D]  workspace
  unsigned long long* bar;         // [1]  the grid barrier's counter
  unsigned epoch;                  // StepArgs::epoch
  const PsQuantScales* scales;     // [L] a quantized stream's scales (layers_dev: its pages)
};

// Sampling of the one row (decode_common.cuh: sample_row).
__global__ void __launch_bounds__(SAMPLE_THREADS)
k1_sample(SampleParams p, float* row, const float* gumbel, int* tok_buf, int* tok_out,
          int buf_len, int suppress) {
  sample_row(p, row, gumbel, tok_buf, tok_out, buf_len, suppress != 0);
}

static int launch_k1_sample(const K1Args* a, cudaStream_t st) {
  const SampleParams s = sample_params_of(a);
  k1_sample<<<1, SAMPLE_THREADS, sample_smem_bytes(s.V, s.NP), st>>>(
      s, a->row_out, a->gumbel, a->tok_buf, a->tok_out, a->buf_len, a->suppress);
  DEC_CHECK();
  return 0;
}

static StepArgs k1_step_args(const K1Args* a) {
  StepArgs s = {};  // (a field left unset is 0: no x_in, a whole step)
  s.B = 1;
  s.L = a->L, s.D = a->D, s.H = a->H, s.M = a->M, s.V = a->V, s.S = a->S, s.P = a->P;
  s.alpha = a->alpha, s.attn_scale = a->attn_scale;
  s.audio_emb = a->audio_emb, s.pe = a->pe, s.predict_w = a->predict_w;
  s.k_cache = a->k_cache, s.v_cache = a->v_cache;
  s.kv_len = nullptr, s.x_len = nullptr, s.last_tok = a->last_tok;
  s.kv_i = a->kv_len, s.pe_i = a->pe_idx;
  s.layers = a->layers_dev;
  PsTagged* t = a->tagged;  // one row: the values carry their tags
  s.x = a->x;
  s.h = t, s.pre = t + a->D, s.qkv = t + 2 * a->D, s.attn = t + 5 * a->D, s.mlp = t + 6 * a->D;
  s.trace = a->trace, s.row_out = a->row_out, s.err = a->err;
  s.epoch = a->epoch, s.bar = nullptr;
  s.scales = a->scales;
  return s;
}

// ---------------------------------------------------------------------------
// Host entry points: the whole step in two launches on ``stream``, the
// layers' weights as bf16 or (k1_decode_step_quant, wq 1 / 2) as int8 /
// int4 pages.  Return the first CUDA error raised by a launch (0 when both
// were accepted).
// ---------------------------------------------------------------------------
extern "C" int k1_decode_step(const K1Args* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if ((rc = launch_decode_step_persistent<1>(k1_step_args(a), st))) return rc;
  return launch_k1_sample(a, st);
}

extern "C" int k1_decode_step_quant(const K1Args* a, int wq, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const StepArgs s = k1_step_args(a);
  int rc;
  if (wq == 1)
    rc = launch_decode_step_persistent<1, 1>(s, st);
  else if (wq == 2)
    rc = launch_decode_step_persistent<1, 2>(s, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return launch_k1_sample(a, st);
}

// ``n`` empty grid barriers on ``bar`` (the cost of one, for chip_smoke.py).
extern "C" int k1_barrier_loop(void* bar, int n, void* err, void* stream) {
  return launch_barrier_loop((unsigned long long*)bar, n, (int*)err, (cudaStream_t)stream);
}
