// K6: one post-norm transformer block for one token per row, B rows with
// per-row cache lengths, on Hopper (sm_90a), as a chain of hand-written
// kernels launched from one host entry point.
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
// row's attended cache rows, 4*kv_len[b]*D bytes: a couple of microseconds,
// below the floor of its 10 launches.  The design is K2's layer
// (decode_common.cuh: decode_layer_rows): a GEMV warp keeps one accumulator
// per row, so the weights cross device memory once for all rows; the
// attention runs on a (head, split, row) grid whose blocks read their own
// row's kv_len on the device.  ROWS_MAX_B = 8 accumulators is the kernel's
// row limit; the wrapper launches larger waves in groups of at most 8 rows
// (rows are independent), passing each group's offset into the cache.
//
// A kv_len outside [0, S) sets ERR_KV_LEN and yields NaN; nothing is clamped.
#define DEC_WITH_ROWS
#include "decode_common.cuh"

struct K6Args {
  int B, D, H, M, S;  // B: rows of this launch, 1..ROWS_MAX_B
  int x_f32;          // x and out are float32 (else bf16)
  float attn_scale;   // 1 / sqrt(Dh)
  const void* x_in;   // [B, D]
  void* x_out;        // [B, D]
  bf16* k_cache;      // [B, S, D]: the layer's cache rows of these B slots
  bf16* v_cache;
  const int* kv_len;  // [B]
  float* x;     // [B, D]   float32 workspace
  float* h;     // [B, D]
  float* qkv;   // [B, 3D]
  float* attn;  // [B, D]
  float* mlp;   // [B, M]
  float* part;  // [B, H, ceil(S / 64), Dh + 2] attention partials
  int* err;     // [1]  ERR_* bits
};

// The host entry point: the layer, launched on ``stream``.  Returns the
// first CUDA error raised by a launch (0 when every launch was accepted).
extern "C" int k6_decode_layer(const K6Args* a, const LayerWeights* w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int B = a->B, D = a->D;
  int rc;
  if (B < 1 || B > ROWS_MAX_B) return (int)cudaErrorInvalidValue;
  if ((rc = launch_rows_load(a->x_in, a->x_f32, a->x, B * D, st))) return rc;
  const RowsWork ws = {a->x, a->h, a->qkv, a->attn, a->mlp, a->part, a->err};
  if ((rc = decode_layer_rows(B, D, a->H, a->M, a->S, a->attn_scale, *w, a->k_cache, a->v_cache,
                              a->kv_len, ws, st)))
    return rc;
  return launch_rows_store(a->x, a->x_out, a->x_f32, B * D, st);
}
