"""K3a / K3b: single-query decode attention over the t2s KV cache with
per-slot lengths (counterpart of ``gsv_tts_tpu/ops/flash_decode.py``).

:func:`flash_decode_attention` takes one layer's cache ``[B, S, H, Dh]``;
:func:`flash_decode_attention_layered` reads layer ``layer`` of the stacked
cache ``[L, B, S, H, Dh]`` without slicing it.  Entries ``s <= kv_len[b]``
are attended (the caller has written the token's own row at ``kv_len[b]``).

On CUDA tensors both launch the hand-written Hopper kernel of
``csrc/k3_flash_decode.cu`` (one body, two entry points; built with ``nvcc``
at first use), which never reads a cache row past ``kv_len[b]``; on CPU
tensors they run the plain PyTorch twin :func:`decode_attention_ref` (the
JAX ``xla_decode_attention``).  There is no fallback between the two.
``kv_len`` stays on the device: the kernel's blocks read their own slot's
entry.  A ``kv_len`` outside ``[0, S)`` yields NaN for that slot and sets a
flag that :func:`check` raises on (it reads one int back, so call it where
the host synchronises anyway).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import cuda_build
from .fused_step import ATTN_ROWS, HEAD_DIMS  # the split attention's limits, shared with K1/K2

#: (library name, sources) for ``cuda_build``
LIBRARY = ("gsv_k3", ["k3_flash_decode.cu"])


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """Plain twin: masked softmax attention over ``s <= kv_len[b]``.
    q [B, H, Dh]; caches [B, S, H, Dh]; float32 scores and probabilities,
    the probabilities rounded to ``q``'s dtype before the value product (as
    the JAX twin does).  Returns [B, H, Dh] in ``q``'s dtype."""
    Dh = q.shape[-1]
    S = k_cache.shape[1]
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k_cache.float()) / math.sqrt(Dh)
    valid = torch.arange(S, device=q.device)[None, :] <= kv_len[:, None]
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bshd->bhd", probs.float(), v_cache.float()).to(q.dtype)


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (first call only) and bind ``csrc/k3_flash_decode.cu``."""
    lib = cuda_build.load_library(*LIBRARY)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k3a_flash_decode.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    lib.k3a_flash_decode.restype = ci
    lib.k3b_flash_decode_layered.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    lib.k3b_flash_decode_layered.restype = ci
    return lib


_scratch = {}  # device -> (partials workspace, error word)


def _workspace(dev: torch.device, n: int):
    part, err = _scratch.get(dev, (None, None))
    if err is None:
        err = torch.zeros(1, dtype=torch.int32, device=dev)
    if part is None or part.numel() < n:
        part = torch.empty(n, dtype=torch.float32, device=dev)
    _scratch[dev] = (part, err)
    return part, err


def check(dev) -> None:
    """Raise if a launch on ``dev`` found a ``kv_len`` outside its cache."""
    _, err = _scratch.get(torch.device(dev), (None, None))
    if err is not None and int(err.item()):
        err.zero_()
        raise RuntimeError("flash decode attention: kv_len outside [0, S) in a launch")


def _fail(msg: str):
    raise ValueError(f"flash_decode_attention: {msg}")


def _launch(entry: str, q, k_cache, v_cache, kv_len, layer):
    """Shared wrapper body; ``layer`` is None for the single-layer form.
    It runs once per layer and step, so messages are built only on failure."""
    cache_shape = k_cache.shape[1:] if layer is not None else k_cache.shape
    if len(cache_shape) != 4 or v_cache.shape != k_cache.shape:
        _fail(f"cache shapes {tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    B, S, H, Dh = cache_shape
    if q.shape != (B, H, Dh):
        _fail(f"q {tuple(q.shape)} is not ({B}, {H}, {Dh})")
    if kv_len.shape != (B,):
        _fail(f"kv_len {tuple(kv_len.shape)} is not ({B},)")
    if layer is not None and not 0 <= layer < k_cache.shape[0]:
        _fail(f"layer {layer} outside [0, {k_cache.shape[0]})")
    dev = q.device
    if dev.type == "cpu":
        kc, vc = (k_cache, v_cache) if layer is None else (k_cache[layer], v_cache[layer])
        return decode_attention_ref(q, kc, vc, kv_len)
    if dev.type != "cuda":
        _fail(f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")
    if Dh not in HEAD_DIMS:
        _fail(f"head dim {Dh} must be one of {HEAD_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        _fail(f"q dtype {q.dtype}")
    for name, t, dtype, align in (("q", q, q.dtype, 4), ("k_cache", k_cache, torch.bfloat16, 16),
                                  ("v_cache", v_cache, torch.bfloat16, 16),
                                  ("kv_len", kv_len, torch.int32, 4)):
        if not (t.device == dev and t.dtype == dtype and t.is_contiguous()
                and t.data_ptr() % align == 0):
            _fail(f"{name} must be a contiguous, {align}-byte aligned {dtype} tensor on {dev}")
    out = torch.empty_like(q)
    part, err = _workspace(dev, B * H * -(-S // ATTN_ROWS) * (Dh + 2))
    args = [q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), part.data_ptr(), err.data_ptr()]
    if layer is not None:
        args.append(layer)
    args += [B, S, H, Dh, int(q.dtype == torch.float32),
             torch.cuda.current_stream(dev).cuda_stream]
    rc = getattr(load_kernels(), entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    return out


def flash_decode_attention(q, k_cache, v_cache, kv_len):
    """K3a.  q [B, H, Dh]; k_cache/v_cache [B, S, H, Dh]; kv_len [B] int32
    (the current token's position).  Returns [B, H, Dh] in ``q``'s dtype."""
    out = _launch("k3a_flash_decode", q, k_cache, v_cache, kv_len, None)
    if q.device.type == "cuda":
        flash_decode_attention.launches += 1
    return out


def flash_decode_attention_layered(q, k_cache, v_cache, kv_len, layer: int):
    """K3b.  Like :func:`flash_decode_attention` on layer ``layer`` (a host
    int) of the stacked caches [L, B, S, H, Dh]."""
    out = _launch("k3b_flash_decode_layered", q, k_cache, v_cache, kv_len, int(layer))
    if q.device.type == "cuda":
        flash_decode_attention_layered.launches += 1
    return out


#: kernel launches since the last reset; the twin never counts
flash_decode_attention.launches = 0
flash_decode_attention_layered.launches = 0
