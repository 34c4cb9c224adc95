// K6: one post-norm transformer block for one token per row, B rows with
// per-row cache lengths, on Hopper (sm_90a), as ONE launch of the persistent
// decode kernel per group of at most 8 rows (decode_step_persistent.cuh as a
// one-layer stack).
//
// Replaces the TPU kernel gsv_tts_tpu/ops/fused_layer.py:_kernel (wrapper
// fused_decode_layer): qkv, per-row attention over the cache rows below
// kv_len[b] of layer ``layer`` plus the token itself (its K/V enter in
// float32), out-proj + residual + LayerNorm, MLP(ReLU) + residual +
// LayerNorm.  The TPU kernel reads the cache only and hands the new rows to
// a scatter outside; here row b's K/V are appended in place at
// [layer, b, kv_len[b]], which is what that scatter does.
//
// What bounds it on the card: bytes -- the layer's matrices once whatever B
// is, 2*(4*D*D + 2*D*M) bytes of bf16 (6.3 MB at D=512, M=2048), plus each
// row's attended cache rows, 4*kv_len[b]*D bytes: a couple of microseconds.
// The first design, a chain of 10 launches (a row load, 8 for the layer, a
// row store), ran below the floor of its launches and followed the host.
// This one is K1's and K2's layer in one launch: one block per SM, the layer's weights (about 48 KB a block on 132 SMs: all of a
// block's tiles fit its ring at once, so every copy is asked for before the
// first product) streamed by bulk copies, each block's attention merged
// inside the block, and between phases tagged values at one row or a grid
// barrier for a group of 2..8 (a group of 3, 5, 6 or 7 runs at the next
// size up, its dead rows reading and writing nothing).  The wrapper passes
// the layer's entry of the device table (a one-layer stack, l = 0) and the
// layer's cache slab at the group's first slot: the slab's rows are
// [B_group, S, D] inside the whole cache's [L, B, S, D].
//
// A kv_len outside [0, S) sets ERR_KV_LEN and yields NaN; nothing is clamped.
#include "decode_step_persistent.cuh"

struct K6Args {
  int B, D, H, M, S;  // B: rows of this launch, 1..8
  int x_f32;          // x and out are float32 (else bf16)
  float attn_scale;   // 1 / sqrt(Dh)
  const void* x_in;   // [B, D]
  void* x_out;        // [B, D]
  bf16* k_cache;      // [B, S, D]: the layer's cache rows of these B slots
  bf16* v_cache;
  const int* kv_len;  // [B]
  float* h;           // [B, D]  a group's workspace
  float* qkv;         // [B, 3D]
  float* attn;        // [B, D]
  float* mlp;         // [B, M]
  float* trace;       // a traced build's clock marks (PS_TRACE_BYTES)
  int* err;           // [1]  ERR_* bits
  // what the persistent kernel reads besides
  const LayerWeights* layers_dev;  // the layer's entry of the table on the device
  PsTagged* tagged;                // one row: [D | D | 3D | D | M] h, pre, qkv, attn, mlp
  float* pre;                      // [B, D]  a group's workspace
  unsigned long long* bar;         // [1]  a group's grid barrier counter
  unsigned epoch;                  // StepArgs::epoch
};

// The host entry point: the layer for this group of rows in one launch on
// ``stream``.  Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int k6_decode_layer(const K6Args* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  StepArgs s = {};
  s.B = a->B;
  s.L = 1, s.D = a->D, s.H = a->H, s.M = a->M, s.S = a->S;
  s.attn_scale = a->attn_scale;
  s.k_cache = a->k_cache, s.v_cache = a->v_cache;
  s.kv_len = a->kv_len;
  s.layers = a->layers_dev;
  s.trace = a->trace, s.err = a->err;
  s.epoch = a->epoch, s.bar = a->bar;
  s.x_in = a->x_in, s.x_out = a->x_out, s.x_f32 = a->x_f32;
  if (a->B == 1) {  // one row: the values carry their tags
    PsTagged* t = a->tagged;
    s.h = t, s.pre = t + a->D, s.qkv = t + 2 * a->D, s.attn = t + 5 * a->D, s.mlp = t + 6 * a->D;
    return launch_decode_step_persistent<1>(s, st);
  }
  s.h = a->h, s.pre = a->pre, s.qkv = a->qkv, s.attn = a->attn, s.mlp = a->mlp;
  if (a->B == 2) return launch_decode_step_persistent<2>(s, st);
  if (a->B <= 4) return launch_decode_step_persistent<4>(s, st);
  if (a->B <= 8) return launch_decode_step_persistent<8>(s, st);
  return (int)cudaErrorInvalidValue;
}
