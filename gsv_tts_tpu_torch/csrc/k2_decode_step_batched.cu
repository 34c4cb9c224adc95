// K2: the whole t2s decode step for a wave of B cache slots on Hopper
// (sm_90a): one persistent cooperative kernel for the model
// (decode_step_persistent.cuh at 2, 4 or 8 rows) and one launch for the
// per-row sampling chain.
//
// Replaces the TPU kernel gsv_tts_tpu/ops/fused_step.py:_kernel_sample_b
// (wrapper fused_decode_step_sample_batched): per-slot embedding +
// positional entry (clamped at 0 for a frozen slot, whose kv_len < x_len),
// L post-norm layers with each slot's K/V row appended in place at its own
// kv_len[b], per-slot single-query attention over [0, kv_len[b]] including
// the new row, the logits head and the per-row sampling chain.
//
// What bounds it on the card: bytes.  A step reads every layer's matrices,
// 2*L*(4*D*D + 2*D*M) + 2*V*D bytes of bf16 (152 MB at L=24, D=512, M=2048,
// V=1025), plus each slot's attended cache rows, 4*L*kv_len[b]*D bytes.  At
// B <= 8 the products do at most 2*B flops per weight, far below the card's
// operations-per-byte ridge: the point of the TPU kernel -- the weight
// stream crosses device memory ONCE per step whatever B is -- is the
// property to keep.  The persistent kernel does: a warp takes a weight row
// (or a slice of its K) from the shared-memory ring once and accumulates B
// dot products against the B activation rows, which sit in shared memory as
// bf16 (they are rounded to bf16 where they enter a product anyway).  The
// kernel is built for 2, 4 and 8 rows; a wave of 1, 3, 5, 6 or 7 runs in the
// next size up, its dead rows touching no cache, no tok_buf and no output
// (the weights cross once whatever the size).
//
// The first version was a chain of 195 launches a step and ran at the
// host's launch rate; decode_step_persistent.cuh says what the one-launch
// design does about that (for a wave: a grid barrier between phases, the
// weight stream running through all of them).
//
// The per-slot counters stay on the device: the block of a (slot, head) reads
// its own slot's kv_len, walks no row past it, and appends the slot's K/V row
// at kv_len[b].  The TPU kernel's 8-row read-modify-write
// windows and strided [B, block, D] walk buffers answer TPU DMA constraints
// and have no counterpart here.  Its three softmax modes ("rows", "vec",
// "shared") are one function in exact arithmetic -- "rows" and "vec" are
// bit-identical, "shared" trades a shared running max for fewer vector ops
// on the TPU -- so one kernel computes the exact per-row online softmax.
//
// k2_decode_step_batched_quant runs the same step on the int8 or int4
// weight stream of the TPU kernel's quant / quant4 modes
// (decode_step_persistent.cuh says how): at 2, 4 and 8 rows, like the bf16
// stream (the engine takes it for waves of 2..6 slots, the TPU kernel's).
//
// Out-of-range values are flagged, never clamped: a last_tok outside
// [0, V), a kv_len outside [0, S) or a positional index outside [0, P) sets
// a bit in ``err`` (the slot then produces NaN or skips its append), which
// the host reads where it synchronises anyway.
#include "decode_step_persistent.cuh"

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
  float* trace;  // a traced build's clock marks (PS_TRACE_BYTES)
  float* row_out;  // [B, V]  logits, then the filtered rows
  int* tok_out;    // [B]
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

static int launch_k2_sample(const K2Args* a, cudaStream_t st) {
  const SampleParams s = sample_params_of(a);
  k2_sample<<<a->B, SAMPLE_THREADS, sample_smem_bytes(s.V, s.NP), st>>>(
      s, a->row_out, a->gumbel, a->tok_buf, a->tok_out, a->buf_len, a->step_idx,
      a->suppress_until);
  DEC_CHECK();
  return 0;
}

static StepArgs k2_step_args(const K2Args* a) {
  StepArgs s = {};  // (a field left unset is 0: no x_in, a whole step)
  s.B = a->B;
  s.L = a->L, s.D = a->D, s.H = a->H, s.M = a->M, s.V = a->V, s.S = a->S, s.P = a->P;
  s.alpha = a->alpha, s.attn_scale = a->attn_scale;
  s.audio_emb = a->audio_emb, s.pe = a->pe, s.predict_w = a->predict_w;
  s.k_cache = a->k_cache, s.v_cache = a->v_cache;
  s.kv_len = a->kv_len, s.x_len = a->x_len, s.last_tok = a->last_tok;
  s.kv_i = 0, s.pe_i = 0;
  s.layers = a->layers_dev;
  s.x = a->x, s.h = a->h, s.pre = a->pre, s.qkv = a->qkv, s.attn = a->attn, s.mlp = a->mlp;
  s.trace = a->trace, s.row_out = a->row_out, s.err = a->err;
  s.epoch = 0, s.bar = a->bar;  // a wave: barriers between the phases
  s.scales = a->scales;
  return s;
}

// The persistent kernel at the smallest of 2, 4, 8 rows that holds the wave.
template <int WQ>
static int k2_launch(const StepArgs& s, cudaStream_t st) {
  if (s.B < 1 || s.B > 8) return (int)cudaErrorInvalidValue;
  if (s.B <= 2) return launch_decode_step_persistent<2, WQ>(s, st);
  if (s.B <= 4) return launch_decode_step_persistent<4, WQ>(s, st);
  return launch_decode_step_persistent<8, WQ>(s, st);
}

// ---------------------------------------------------------------------------
// Host entry points: the whole step in two launches on ``stream``, the
// layers' weights as bf16 or (k2_decode_step_batched_quant, wq 1 / 2) as
// int8 / int4 pages.  Return the first CUDA error raised by a launch (0 when
// both were accepted).
// ---------------------------------------------------------------------------
extern "C" int k2_decode_step_batched(const K2Args* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if ((rc = k2_launch<0>(k2_step_args(a), st))) return rc;
  return launch_k2_sample(a, st);
}

extern "C" int k2_decode_step_batched_quant(const K2Args* a, int wq, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const StepArgs s = k2_step_args(a);
  int rc;
  if (wq == 1)
    rc = k2_launch<1>(s, st);
  else if (wq == 2)
    rc = k2_launch<2>(s, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return launch_k2_sample(a, st);
}
