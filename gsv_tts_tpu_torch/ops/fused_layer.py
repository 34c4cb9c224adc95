"""K6: one whole transformer block for one token per row (counterpart of
``gsv_tts_tpu/ops/fused_layer.py``): qkv, per-row attention over the cache
rows below ``kv_len[b]`` plus the token itself, out-proj + residual +
LayerNorm, MLP(ReLU) + residual + LayerNorm, with the row's new K/V appended
in place at ``[layer, b, kv_len[b]]`` of the stacked caches.

On CUDA tensors :func:`fused_decode_layer` launches the hand-written Hopper
kernel of ``csrc/k6_decode_layer.cu`` (built with ``nvcc`` at first use): the
persistent decode kernel K1, K2 and K5 run (``csrc/decode_step_persistent.cuh``)
as a one-layer stack, one cooperative launch per group of at most
``MAX_FUSED_B`` rows (rows are independent; a group of 3, 5, 6 or 7 runs at
the kernel's next row count, its dead rows touching nothing); on CPU tensors
it runs the plain PyTorch twin :func:`fused_decode_layer_ref`.  There is no
fallback between the two.  ``kv_len`` stays on the device; a value outside
``[0, S)`` yields NaN for that row and sets the flag ``ops.fused_step.check``
raises on.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..utils import cuda_build
from .flash_decode import _contiguous, meta
from .fused_step import (_WAVE_ROWS, HEAD_DIMS, MAX_FUSED_B, _layers_fields, _need,
                         check_hidden_rows, decode_layers_ref, table_for)

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
    _fields_ = ([(n, ctypes.c_int) for n in ("B", "D", "H", "M", "S", "x_f32")]
                + _layers_fields(_WAVE_ROWS))


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (first call only) and bind ``csrc/k6_decode_layer.cu``."""
    lib = cuda_build.load_library(*LIBRARY)
    lib.k6_decode_layer.argtypes = [ctypes.POINTER(_K6Args), ctypes.c_void_p]
    lib.k6_decode_layer.restype = ctypes.c_int
    return lib


class Plan(NamedTuple):
    L: int
    B: int
    S: int
    H: int
    Dh: int
    x_f32: int


@functools.lru_cache(maxsize=None)
def launch_plan(x, k_cache, v_cache, kv_len) -> Plan:
    """Check one CUDA call from its tensors' :func:`~.flash_decode.meta`
    (what :func:`~.fused_step.check_hidden_rows` checks of CUDA tensors) and
    return its plan; raises ``ValueError`` on what the kernel does not take.
    A pure function of its arguments, memoized on them: the "fused" path
    calls K6 once per layer and step, and its host time is the call's."""
    (x_shape, _, x_dtype, dev, _), (k_shape, *_) = x, k_cache
    _need(len(k_shape) == 5 and v_cache[0] == k_shape,
          f"cache shapes {tuple(k_shape)} / {tuple(v_cache[0])}")
    L, B, S, H, Dh = k_shape
    _need(tuple(x_shape) == (B, H * Dh), f"x {tuple(x_shape)} is not ({B}, {H * Dh})")
    _need(tuple(kv_len[0]) == (B,), f"kv_len must be a [{B}] tensor")
    _need(dev.type == "cuda", f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")
    _need(Dh in HEAD_DIMS, f"head dim {Dh} must be one of {HEAD_DIMS}")
    _need(x_dtype in (torch.bfloat16, torch.float32), f"x dtype {x_dtype}")
    for name, (shape, stride, dtype, t_dev, mis), want, align in (
            ("x", x, x_dtype, 4), ("k_cache", k_cache, torch.bfloat16, 16),
            ("v_cache", v_cache, torch.bfloat16, 16), ("kv_len", kv_len, torch.int32, 4)):
        _need(t_dev == dev and dtype == want and _contiguous(shape, stride) and mis % align == 0,
              f"{name} must be a contiguous, {align}-byte aligned {want} tensor on {dev}")
    return Plan(L, B, S, H, Dh, int(x_dtype == torch.float32))


def _run_groups(x, lp, k_cache, v_cache, kv_len, layer: int, table):
    """Launch K6 on CUDA tensors: one launch per group of at most
    ``MAX_FUSED_B`` rows.  Returns the output rows.  Messages are built only
    on failure."""
    ptrs = x.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr()
    p = launch_plan(meta(x, ptrs[0]), meta(k_cache, ptrs[1]), meta(v_cache, ptrs[2]),
                    meta(kv_len, ptrs[3]))
    if not 0 <= layer < p.L:
        _need(False, f"layer {layer} outside [0, {p.L})")
    B, S, H, Dh = p.B, p.S, p.H, p.Dh
    D = H * Dh
    at = 0 if table is None else layer  # a one-call table holds only ``lp``
    table = table_for(table, [lp], at)
    if table.D != D:
        _need(False, f"cache width {D} does not match the weights' {table.D}")
    # a group of one row hands over through tagged values, the others through a grid barrier
    table.check_persistent(tagged=B % MAX_FUSED_B == 1)
    out = torch.empty_like(x)
    lib = load_kernels()
    a = _K6Args()
    a.D, a.H, a.M, a.S = D, H, table.M, S
    a.x_f32 = p.x_f32
    a.attn_scale = 1.0 / math.sqrt(Dh)
    table.work(a)
    stream = cuda_build.stream_handle(x.device)
    row = D * x.element_size()
    slab = (layer * B) * S * D * 2  # the layer's slab: its stride is the whole cache's B
    for b0 in range(0, B, MAX_FUSED_B):
        a.B = min(MAX_FUSED_B, B - b0)
        a.x_in, a.x_out = ptrs[0] + b0 * row, out.data_ptr() + b0 * row
        a.k_cache = ptrs[1] + slab + b0 * S * D * 2  # at the group's first slot
        a.v_cache = ptrs[2] + slab + b0 * S * D * 2
        a.kv_len = ptrs[3] + b0 * 4
        table.persistent(a, at)
        rc = lib.k6_decode_layer(ctypes.byref(a), stream)
        if rc != 0:
            raise RuntimeError(f"K6 launch failed: CUDA error {rc}")
        fused_decode_layer.launches += 1
    return out


def _check(x, k_cache, v_cache, kv_len, layer: int) -> int:
    """The checks of a call off the card (its twin's on the CPU)."""
    check_hidden_rows(x, k_cache, v_cache, kv_len)
    layer = int(layer)
    L = k_cache.shape[0]
    _need(0 <= layer < L, f"layer {layer} outside [0, {L})")
    return layer


def fused_decode_layer(x, lp, k_cache, v_cache, kv_len, layer: int, *, table=None):
    """K6.  ``x`` [B, D] (bf16 or float32); ``lp`` one layer's parameter
    dict; ``k_cache``/``v_cache`` the stacked [L, B, S, H, Dh] buffers, of
    which layer ``layer`` (a host int) is read and row ``kv_len[b]`` of slot
    b written in place; ``kv_len`` [B] int32 on the tensors' device;
    ``table`` the ``LayerTable`` built over all the model's layers
    (``params["k1_table"]``), whose entry ``layer`` must be ``lp``.  Returns
    ``(x_out [B, D] in x's dtype, k_cache, v_cache)``."""
    if x.device.type != "cuda":
        layer = _check(x, k_cache, v_cache, kv_len, layer)  # (raises off the CPU)
        return fused_decode_layer_ref(x, lp, k_cache, v_cache, kv_len, layer)
    return _run_groups(x, lp, k_cache, v_cache, kv_len, int(layer), table), k_cache, v_cache


#: kernel launches since the last reset (one per group of rows); the twin
#: never counts
fused_decode_layer.launches = 0
