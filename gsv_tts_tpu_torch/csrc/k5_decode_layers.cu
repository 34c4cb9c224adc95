// K5: one token through all L post-norm layers at B=1 on Hopper (sm_90a), as
// ONE launch of the persistent decode kernel (decode_step_persistent.cuh as a
// layer stack at one row).
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
// embedding and the head.  The design is K1's: one cooperative launch with
// one block per SM, the layers' weights streamed through each block's
// shared-memory ring of bulk copies from the first tile to the last MLP-2's
// (the list ends there: no head), values handed from phase to phase with the
// tag of this launch and layer instead of launches or barriers.  The first
// row is x_in itself (promoted to float32: it is also the first residual);
// block 0 normalises the last layer's rows and stores them in x's type.
// kv_len stays on the device: the blocks read its word there, and the caller
// never reads it back.
//
// A kv_len outside [0, S) sets ERR_KV_LEN and yields NaN; nothing is clamped.
#include "decode_step_persistent.cuh"

struct K5Args {
  int L, D, H, M, S;
  int x_f32;          // x and out are float32 (else bf16)
  float attn_scale;   // 1 / sqrt(Dh)
  const void* x_in;   // [1, D]
  void* x_out;        // [1, D]
  bf16* k_cache;      // [L, S, D]  (the [L, 1, S, H, Dh] cache)
  bf16* v_cache;
  const int* kv_len;  // [1]
  float* trace;       // a traced build's clock marks (PS_TRACE_BYTES)
  int* err;           // [1]  ERR_* bits
  // what the persistent kernel reads besides
  const LayerWeights* layers_dev;  // [L] the layer table on the device
  PsTagged* tagged;                // [D | D | 3D | D | M]: one row's h, pre, qkv, attn, mlp
  float* pre;                      // (a wave's; unused at one row)
  unsigned long long* bar;         // (a wave's; unused at one row)
  unsigned epoch;                  // StepArgs::epoch
};

// The host entry point: the L layers in one launch on ``stream``.  Returns
// the CUDA error of the launch (0 when it was accepted).
extern "C" int k5_decode_layers(const K5Args* a, void* stream) {
  StepArgs s = {};
  s.B = 1;
  s.L = a->L, s.D = a->D, s.H = a->H, s.M = a->M, s.S = a->S;
  s.attn_scale = a->attn_scale;
  s.k_cache = a->k_cache, s.v_cache = a->v_cache;
  s.kv_len = a->kv_len;
  s.layers = a->layers_dev;
  PsTagged* t = a->tagged;  // one row: the values carry their tags
  s.h = t, s.pre = t + a->D, s.qkv = t + 2 * a->D, s.attn = t + 5 * a->D, s.mlp = t + 6 * a->D;
  s.trace = a->trace, s.err = a->err;
  s.epoch = a->epoch;
  s.x_in = a->x_in, s.x_out = a->x_out, s.x_f32 = a->x_f32;
  return launch_decode_step_persistent<1>(s, (cudaStream_t)stream);
}
