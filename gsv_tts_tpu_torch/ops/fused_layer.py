"""K6: one whole transformer block for one token per row (counterpart of
``gsv_tts_tpu/ops/fused_layer.py``): qkv, per-row attention over the cache
rows below ``kv_len[b]`` plus the token itself, out-proj + residual +
LayerNorm, MLP(ReLU) + residual + LayerNorm, with the row's new K/V appended
in place at ``[layer, b, kv_len[b]]`` of the stacked caches.

On CUDA tensors :func:`fused_decode_layer` launches the hand-written Hopper
kernel chain of ``csrc/k6_decode_layer.cu`` (built with ``nvcc`` at first
use; the layer itself is the device code K1, K2 and K5 run, shared in
``csrc/decode_common.cuh``); on CPU tensors it runs the plain PyTorch twin
:func:`fused_decode_layer_ref`.  There is no fallback between the two.  The
kernel keeps one accumulator per row in its weight-streaming GEMV, so it
takes at most ``MAX_FUSED_B`` rows a launch; a larger wave goes through it in
groups of that many rows (rows are independent), never through the twin.
``kv_len`` stays on the device; a value outside ``[0, S)`` yields NaN for
that row and sets the flag ``ops.fused_step.check`` raises on.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import cuda_build
from .fused_step import (MAX_FUSED_B, _LayerWeights, _need, check_hidden_rows,
                         decode_layers_ref, table_for)

#: (library name, sources) for ``cuda_build``
LIBRARY = ("gsv_k6", ["k6_decode_layer.cu"])


def fused_decode_layer_ref(x, lp, k_cache, v_cache, kv_len, layer: int):
    """Plain PyTorch twin: ``x`` [B, D] through the block ``lp`` against
    layer ``layer`` of the caches, row b's K/V written in place at
    ``kv_len[b]``.  Returns ``(x_out [B, D] in x's dtype, k_cache,
    v_cache)``."""
    h = decode_layers_ref(x.float(), [lp], k_cache, v_cache, kv_len.reshape(-1).long(), layer)
    return h.to(x.dtype), k_cache, v_cache


class _K6Args(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_int) for n in ("B", "D", "H", "M", "S", "x_f32")]
        + [("attn_scale", ctypes.c_float)]
        + [(n, ctypes.c_void_p) for n in ("x_in", "x_out", "k_cache", "v_cache", "kv_len",
                                          "x", "h", "qkv", "attn", "mlp", "part", "err")]
    )


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (first call only) and bind ``csrc/k6_decode_layer.cu``."""
    lib = cuda_build.load_library(*LIBRARY)
    lib.k6_decode_layer.argtypes = [ctypes.POINTER(_K6Args), ctypes.POINTER(_LayerWeights),
                                    ctypes.c_void_p]
    lib.k6_decode_layer.restype = ctypes.c_int
    return lib


def fused_decode_layer(x, lp, k_cache, v_cache, kv_len, layer: int, *, table=None):
    """K6.  ``x`` [B, D] (bf16 or float32); ``lp`` one layer's parameter
    dict; ``k_cache``/``v_cache`` the stacked [L, B, S, H, Dh] buffers, of
    which layer ``layer`` (a host int) is read and row ``kv_len[b]`` of slot
    b written in place; ``kv_len`` [B] int32 on the tensors' device;
    ``table`` the ``LayerTable`` built over all the model's layers
    (``params["k1_table"]``), whose entry ``layer`` must be ``lp``.  Returns
    ``(x_out [B, D] in x's dtype, k_cache, v_cache)``."""
    check_hidden_rows(x, k_cache, v_cache, kv_len)
    L, B, S, H, Dh = k_cache.shape
    layer = int(layer)
    _need(0 <= layer < L, f"layer {layer} outside [0, {L})")
    dev = x.device
    if dev.type == "cpu":
        return fused_decode_layer_ref(x, lp, k_cache, v_cache, kv_len, layer)
    at = 0 if table is None else layer  # a one-call table holds only ``lp``
    table = table_for(table, [lp], at)
    D = H * Dh
    _need(table.D == D, f"cache width {D} does not match the weights' {table.D}")
    out = torch.empty_like(x)
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    a = _K6Args()
    a.D, a.H, a.M, a.S = D, H, table.M, S
    a.x_f32 = int(x.dtype == torch.float32)
    a.attn_scale = 1.0 / math.sqrt(Dh)
    table.work(a, min(B, MAX_FUSED_B), S, H, Dh)
    for b0 in range(0, B, MAX_FUSED_B):  # groups of at most MAX_FUSED_B rows
        a.B = min(MAX_FUSED_B, B - b0)
        a.x_in = x.data_ptr() + b0 * D * x.element_size()
        a.x_out = out.data_ptr() + b0 * D * x.element_size()
        slot0 = (layer * B + b0) * S * D * k_cache.element_size()
        a.k_cache, a.v_cache = k_cache.data_ptr() + slot0, v_cache.data_ptr() + slot0
        a.kv_len = kv_len.data_ptr() + b0 * kv_len.element_size()
        rc = lib.k6_decode_layer(ctypes.byref(a), ctypes.byref(table.layers[at]), stream)
        if rc != 0:
            raise RuntimeError(f"K6 launch failed: CUDA error {rc}")
        fused_decode_layer.launches += 1
    return out, k_cache, v_cache


#: kernel launches since the last reset (one per group of rows); the twin
#: never counts
fused_decode_layer.launches = 0
