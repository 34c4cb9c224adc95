"""K3a / K3b: single-query decode attention over the t2s KV cache with
per-slot lengths (counterpart of ``gsv_tts_tpu/ops/flash_decode.py``).

:func:`flash_decode_attention` takes one layer's cache ``[B, S, H, Dh]``;
:func:`flash_decode_attention_layered` reads layer ``layer`` of the stacked
cache ``[L, B, S, H, Dh]`` without slicing it.  Entries ``s <= kv_len[b]``
are attended (the caller has written the token's own row at ``kv_len[b]``).

On CUDA tensors both launch the hand-written Hopper kernel of
``csrc/k3_flash_decode.cu`` (one body, two entry points; built with ``nvcc``
at first use): one launch a call, a cluster of :func:`cluster_plan` blocks
for each (slot, head), merged through distributed shared memory; it never
reads a cache row past ``kv_len[b]``.  On CPU tensors they run the plain
PyTorch twin :func:`decode_attention_ref` (the JAX ``xla_decode_attention``).
There is no fallback between the two.  ``kv_len`` stays on the device: the
kernel's blocks read their own slot's entry.  A ``kv_len`` outside
``[0, S)`` yields NaN for that slot and sets a flag that :func:`check` raises
on (it reads one int back, so call it where the host synchronises anyway).

The argument checks of a launch are a pure function of the tensors'
metadata, :func:`launch_plan`, memoized on it: a call whose shapes, strides,
dtypes, device and 16-byte alignment were seen before pays a dictionary
lookup, and any change of them is checked afresh.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..utils import cuda_build
from .fused_step import HEAD_DIMS  # the attention walk's head dims, shared with K1/K2

#: (library name, sources) for ``cuda_build``
LIBRARY = ("gsv_k3", ["k3_flash_decode.cu"])

#: the largest cluster the kernel takes (csrc K3_MAX_CLUSTER; 8 is the portable limit)
MAX_CLUSTER = 8
#: the fewest cache rows :func:`cluster_plan` leaves a block of a cluster
ATTN_ROWS = 64
#: the largest cluster :func:`cluster_plan` picks: at B=1, H=16, S=1024 on an
#: H100 clusters of 4 ran 0.2-0.3 us ahead of 8 in every measurement (the
#: merge over 8 ranks costs more than halving each block's rows saves)
PLAN_MAX_CLUSTER = 4


def xla_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """The engine's ``"xla"`` decode attention (the JAX package's function of
    that name, its path without a Pallas kernel): masked softmax attention
    over ``s <= kv_len[b]`` in plain PyTorch on any device, float32 scores,
    the probabilities in ``q``'s dtype for the value product.  q [B, H, Dh];
    one layer's caches [B, S, H, Dh].  Launches no kernel of this package."""
    Dh = q.shape[-1]
    S = k_cache.shape[1]
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k_cache.float()) / math.sqrt(Dh)
    valid = torch.arange(S, device=q.device)[None, :] <= kv_len[:, None]
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bshd->bhd", probs, v_cache.to(q.dtype))


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


def cluster_plan(B: int, H: int, S: int, sms: int) -> int:
    """Blocks per (slot, head) of one launch: the largest power of two
    ``C <= PLAN_MAX_CLUSTER`` whose ``B * H * C`` blocks still fit the card's
    ``sms`` streaming multiprocessors, and no more than give every block
    ``ATTN_ROWS`` of the ``S`` rows.  At H=16 on 132 SMs: 4 at B=1 and 2, 2 at
    B=4, 1 from B=5 on."""
    C = 1
    while C < PLAN_MAX_CLUSTER and 2 * C * B * H <= sms and 2 * C * ATTN_ROWS <= S:
        C *= 2
    return C


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of the card ``dev`` (read once per device)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (first call only) and bind ``csrc/k3_flash_decode.cu``."""
    lib = cuda_build.load_library(*LIBRARY)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k3a_flash_decode.argtypes = [vp] * 6 + [ci] * 6 + [vp]
    lib.k3b_flash_decode_layered.argtypes = [vp] * 6 + [ci] * 7 + [vp]
    for fn in (lib.k3a_flash_decode, lib.k3b_flash_decode_layered):
        fn.restype = ci
    return lib


_err_words = {}  # device -> the [1] int32 word the K3 launches set ERR_KV_LEN in


def _device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _err_word(dev: torch.device) -> torch.Tensor:
    err = _err_words.get(dev)
    if err is None:
        err = _err_words[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return err


def check(dev) -> None:
    """Raise if a launch on ``dev`` found a ``kv_len`` outside its cache."""
    err = _err_words.get(_device(dev))
    if err is not None and int(err.item()):
        err.zero_()
        raise RuntimeError("flash decode attention: kv_len outside [0, S) in a launch")


def _fail(msg: str):
    raise ValueError(f"flash_decode_attention: {msg}")


def _shapes(layered: bool, q_shape, k_shape, v_shape, kv_shape):
    """(B, S, H, Dh) of a call, or raise."""
    cache_shape = k_shape[1:] if layered else k_shape
    if len(cache_shape) != 4 or v_shape != k_shape:
        _fail(f"cache shapes {tuple(k_shape)} / {tuple(v_shape)}")
    B, S, H, Dh = cache_shape
    if q_shape != (B, H, Dh):
        _fail(f"q {tuple(q_shape)} is not ({B}, {H}, {Dh})")
    if kv_shape != (B,):
        _fail(f"kv_len {tuple(kv_shape)} is not ({B},)")
    return B, S, H, Dh


def _contiguous(shape, stride) -> bool:
    want = 1
    for n, s in zip(reversed(shape), reversed(stride)):
        if n != 1 and s != want:
            return False
        want *= n
    return True


def meta(t: torch.Tensor, ptr: int):
    """What :func:`launch_plan` checks of a tensor at ``ptr`` (its
    ``data_ptr()``): (shape, strides, dtype, device, ``ptr % 16``)."""
    return t.shape, t.stride(), t.dtype, t.device, ptr % 16


class Plan(NamedTuple):
    L: int  # layers of the stacked cache (1 for one layer's cache)
    B: int
    S: int
    H: int
    Dh: int
    q_f32: int
    C: int  # blocks per (slot, head): cluster_plan(B, H, S, sms)


@functools.lru_cache(maxsize=None)
def launch_plan(layered: bool, q, k_cache, v_cache, kv_len, sms: int) -> Plan:
    """Check one CUDA launch from its tensors' :func:`meta` and return its
    plan for a card of ``sms`` SMs; raises ``ValueError`` on what the kernel
    does not take.  A pure function of its arguments, memoized on them."""
    (q_shape, q_stride, q_dtype, dev, _), (k_shape, *_) = q, k_cache
    B, S, H, Dh = _shapes(layered, q_shape, k_shape, v_cache[0], kv_len[0])
    if dev.type != "cuda":
        _fail(f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")
    if Dh not in HEAD_DIMS:
        _fail(f"head dim {Dh} must be one of {HEAD_DIMS}")
    if q_dtype not in (torch.bfloat16, torch.float32):
        _fail(f"q dtype {q_dtype}")
    for name, (shape, stride, dtype, t_dev, mis), want, align in (
            ("q", q, q_dtype, 4), ("k_cache", k_cache, torch.bfloat16, 16),
            ("v_cache", v_cache, torch.bfloat16, 16), ("kv_len", kv_len, torch.int32, 4)):
        if not (t_dev == dev and dtype == want and _contiguous(shape, stride)
                and mis % align == 0):
            _fail(f"{name} must be a contiguous, {align}-byte aligned {want} tensor on {dev}")
    return Plan(k_shape[0] if layered else 1, B, S, H, Dh, int(q_dtype == torch.float32),
                cluster_plan(B, H, S, sms))


def _cuda_plan(q, k_cache, v_cache, kv_len, layer, ptrs):
    p = launch_plan(layer is not None, meta(q, ptrs[0]), meta(k_cache, ptrs[1]),
                    meta(v_cache, ptrs[2]), meta(kv_len, ptrs[3]), sm_count(q.device))
    if layer is not None and not 0 <= layer < p.L:
        _fail(f"layer {layer} outside [0, {p.L})")
    return p


def _launch(entry: str, q, k_cache, v_cache, kv_len, layer):
    """Shared wrapper body; ``layer`` is None for the single-layer form.
    It runs once per layer and step, so messages are built only on failure."""
    dev = q.device
    if dev.type != "cuda":
        _shapes(layer is not None, tuple(q.shape), tuple(k_cache.shape), tuple(v_cache.shape),
                tuple(kv_len.shape))
        if layer is not None and not 0 <= layer < k_cache.shape[0]:
            _fail(f"layer {layer} outside [0, {k_cache.shape[0]})")
        if dev.type != "cpu":
            _fail(f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")
        kc, vc = (k_cache, v_cache) if layer is None else (k_cache[layer], v_cache[layer])
        return decode_attention_ref(q, kc, vc, kv_len)
    ptrs = q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr()
    p = _cuda_plan(q, k_cache, v_cache, kv_len, layer, ptrs)
    out = torch.empty_like(q)
    lib = load_kernels()
    if layer is None:
        rc = lib.k3a_flash_decode(*ptrs, out.data_ptr(), _err_word(dev).data_ptr(), p.B, p.S, p.H,
                                  p.Dh, p.q_f32, p.C, cuda_build.stream_handle(dev))
    else:
        rc = lib.k3b_flash_decode_layered(*ptrs, out.data_ptr(), _err_word(dev).data_ptr(), layer,
                                          p.B, p.S, p.H, p.Dh, p.q_f32, p.C,
                                          cuda_build.stream_handle(dev))
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
