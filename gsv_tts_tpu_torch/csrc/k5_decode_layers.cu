// K5: one token through all L post-norm layers at B=1 on Hopper (sm_90a),
// as a chain of hand-written kernels launched from one host entry point.
//
// Replaces the TPU kernel gsv_tts_tpu/ops/fused_step.py:_kernel (wrapper
// fused_decode_step): the given hidden row goes through qkv, the attention
// over the cache rows below kv_len plus the token itself (its K/V enter in
// float32), out-proj + residual + LayerNorm, MLP(ReLU) + residual +
// LayerNorm, L times; no embedding, head or sampling.  The TPU kernel hands
// the new K/V rows back for a scatter outside; here every layer's row is
// appended in place at kv_len, which is what that scatter does.
//
// What bounds it on the card: bytes -- every layer's matrices once,
// 2*L*(4*D*D + 2*D*M) bytes of bf16 (about 151 MB at L=24, D=512, M=2048),
// plus the attended cache rows, 4*L*kv_len*D bytes; K1's bound without the
// embedding and the head.  The design is K2's layer (decode_common.cuh:
// decode_layer_rows) at one row: a warp per output row streams the weight
// row once with 16-byte loads, the attention is split into 64-row pieces
// over (head, split) blocks, and kv_len stays on the device -- every block
// reads it there, so the caller never reads it back.  The TPU kernel's
// double-buffered weight DMA answers a VMEM staging constraint and has no
// counterpart: the GEMV blocks of one layer already keep the memory system
// busy while the next launch is queued.  8 launches per layer; a persistent
// fused kernel and CUDA-graph capture are later work.
//
// A kv_len outside [0, S) sets ERR_KV_LEN and yields NaN; nothing is clamped.
#define DEC_WITH_ROWS
#include "decode_common.cuh"

struct K5Args {
  int L, D, H, M, S;
  int x_f32;          // x and out are float32 (else bf16)
  float attn_scale;   // 1 / sqrt(Dh)
  const void* x_in;   // [1, D]
  void* x_out;        // [1, D]
  bf16* k_cache;      // [L, S, D]  (the [L, 1, S, H, Dh] cache)
  bf16* v_cache;
  const int* kv_len;  // [1]
  float* x;     // [D]   float32 workspace
  float* h;     // [D]
  float* qkv;   // [3D]
  float* attn;  // [D]
  float* mlp;   // [M]
  float* part;  // [H, ceil(S / 64), Dh + 2] attention partials
  int* err;     // [1]  ERR_* bits
};

// The host entry point: the L layers, launched on ``stream``.  Returns the
// first CUDA error raised by a launch (0 when every launch was accepted).
extern "C" int k5_decode_layers(const K5Args* a, const LayerWeights* layers, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int D = a->D, S = a->S;
  int rc;
  if ((rc = launch_rows_load(a->x_in, a->x_f32, a->x, D, st))) return rc;
  const RowsWork ws = {a->x, a->h, a->qkv, a->attn, a->mlp, a->part, a->err};
  for (int l = 0; l < a->L; ++l) {
    if ((rc = decode_layer_rows(1, D, a->H, a->M, S, a->attn_scale, layers[l],
                                a->k_cache + (size_t)l * S * D, a->v_cache + (size_t)l * S * D,
                                a->kv_len, ws, st)))
      return rc;
  }
  return launch_rows_store(a->x, a->x_out, a->x_f32, D, st);
}
