"""K4: prefill self-attention under the t2s hybrid prompt mask (counterpart
of ``gsv_tts_tpu/ops/flash_prefill.py``).

Row r of batch entry b attends column c iff

    (c < xl  or  (r >= xl and c <= r))  and  c < xyl

with ``xl = x_lens[b]`` and ``xyl = xy_lens[b]``: the phoneme block is
bidirectional and never sees audio, audio rows are causal over everything
valid, pad columns are dead, and pad rows (``r >= xyl``) attend every valid
column, so no row is empty while ``xyl >= 1``.

On CUDA tensors :func:`flash_prefill_attention` launches the hand-written
Hopper kernel of ``csrc/k4_flash_prefill.cu`` (built with ``nvcc`` at first
use), which never writes the ``[B, H, T, T]`` scores to device memory and
stops every row at its last attended column: bf16 on the tensor cores
(``mma.sync``, K/V tiles through a ``cp.async`` ring), float32 on the CUDA
cores; the body is picked by dtype alone.  On CPU tensors it runs the plain
PyTorch twin :func:`flash_prefill_attention_ref`.  There is no fallback
between the two.  ``q``/``k``/``v`` may be strided views (the model passes
slices of the ``[B, T, 3D]`` qkv product); the lengths stay on the device.
Lengths outside ``0 <= xl``, ``1 <= xyl <= T`` give that batch entry NaN and
set a bit in the t2s kernels' error word, which ``ops.fused_step.check``
raises on (it reads one int back, so call it where the host synchronises
anyway).  The argument checks are a pure function of the tensors' metadata,
:func:`launch_plan`, memoized on it together with the shape and stride
block the kernel reads, so a repeated call builds nothing but its output.

The twin takes one softmax per row in float32 and rounds the probabilities
to ``v``'s dtype before the value product, as the TPU kernel does; the CUDA
kernel runs an online softmax that keeps them in float32.  In float32 the
two agree to ~1e-6, in bf16 to the rounding of the probabilities.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..utils import cuda_build
from .flash_decode import meta
from .fused_step import HEAD_DIMS, error_word

#: (library name, sources) for ``cuda_build``
LIBRARY = ("gsv_k4", ["k4_flash_prefill.cu"])


def hybrid_mask(T: int, x_lens: torch.Tensor, xy_lens: torch.Tensor) -> torch.Tensor:
    """The boolean mask [B, T, T] (row, column) of the rule above."""
    dev = x_lens.device
    rows = torch.arange(T, device=dev)[None, :, None]
    cols = torch.arange(T, device=dev)[None, None, :]
    xl = x_lens.reshape(-1, 1, 1)
    return ((cols < xl) | ((rows >= xl) & (cols <= rows))) & (cols < xy_lens.reshape(-1, 1, 1))


def flash_prefill_attention_ref(q, k, v, x_lens, xy_lens, *, num_heads: int):
    """Plain twin.  q/k/v [B, T, H, Dh]; float32 scores, one softmax per
    row, probabilities rounded to ``v``'s dtype before the value product.
    Returns [B, T, H*Dh] in ``q``'s dtype."""
    B, T, H, Dh = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(Dh)
    scores = scores.masked_fill(~hybrid_mask(T, x_lens, xy_lens)[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.reshape(B, T, H * Dh).to(q.dtype)


class K4Shape(ctypes.Structure):
    """What a call's shapes and strides fix (csrc ``K4Shape``)."""
    _fields_ = (
        [(n, ctypes.c_int) for n in ("B", "T", "H", "Dh", "is_f32")]
        + [(f"{t}_{s}", ctypes.c_longlong) for t in "qkv" for s in ("sb", "st", "sh")]
    )


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (first call only) and bind ``csrc/k4_flash_prefill.cu``."""
    lib = cuda_build.load_library(*LIBRARY)
    lib.k4_flash_prefill.argtypes = [ctypes.c_void_p] * 9
    lib.k4_flash_prefill.restype = ctypes.c_int
    return lib


def _fail(msg: str):
    raise ValueError(f"flash_prefill_attention: {msg}")


def _shapes(q_shape, k_shape, v_shape, x_shape, xy_shape, num_heads):
    """(B, T, H, Dh) of a call, or raise."""
    if len(q_shape) != 4 or k_shape != q_shape or v_shape != q_shape:
        _fail(f"q/k/v shapes {tuple(q_shape)} / {tuple(k_shape)} / {tuple(v_shape)}")
    B, T, H, Dh = q_shape
    if H != num_heads:
        _fail(f"{H} heads in q, num_heads={num_heads}")
    for name, shape in (("x_lens", x_shape), ("xy_lens", xy_shape)):
        if shape != (B,):
            _fail(f"{name} must be a [{B}] tensor")
    return B, T, H, Dh


class Plan(NamedTuple):
    out_shape: tuple
    shape: K4Shape  # kept alive here: the kernel reads it through ``shape_ptr``
    shape_ptr: int


@functools.lru_cache(maxsize=None)
def launch_plan(q, k, v, x_lens, xy_lens, num_heads: int) -> Plan:
    """Check one CUDA launch from its tensors' :func:`~.flash_decode.meta`
    and return its plan; raises ``ValueError`` on what the kernel does not
    take.  A pure function of its arguments, memoized on them."""
    B, T, H, Dh = _shapes(q[0], k[0], v[0], x_lens[0], xy_lens[0], num_heads)
    dtype, dev = q[2], q[3]
    if dev.type != "cuda":
        _fail(f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")
    if Dh not in HEAD_DIMS:
        _fail(f"head dim {Dh} must be one of {HEAD_DIMS}")
    if dtype not in (torch.bfloat16, torch.float32):
        _fail(f"dtype {dtype}")
    if dtype == torch.float32 and Dh > 64:
        _fail(f"float32 with head dim {Dh}: the kernel's float32 tiles hold heads up to 64 wide")
    vec = 8 if dtype == torch.bfloat16 else 4  # elements per 16-byte load
    for name, (_, stride, t_dtype, t_dev, mis) in (("q", q), ("k", k), ("v", v)):
        if not (t_dev == dev and t_dtype == dtype and stride[3] == 1 and mis == 0
                and all(s % vec == 0 for s in stride[:3])):
            _fail(f"{name} must be a {dtype} tensor on {dev} with a contiguous last dimension "
                  f"and 16-byte aligned rows (strides {stride})")
    for name, (_, stride, t_dtype, t_dev, _) in (("x_lens", x_lens), ("xy_lens", xy_lens)):
        if not (t_dev == dev and t_dtype == torch.int32 and (B == 1 or stride[0] == 1)):
            _fail(f"{name} must be a contiguous int32 tensor on {dev}")
    s = K4Shape(B=B, T=T, H=H, Dh=Dh, is_f32=int(dtype == torch.float32))
    for name, (_, stride, *_) in (("q", q), ("k", k), ("v", v)):
        for field, i in (("sb", 0), ("st", 1), ("sh", 2)):
            setattr(s, f"{name}_{field}", stride[i])
    return Plan((B, T, H * Dh), s, ctypes.addressof(s))


def _launch(q, k, v, x_lens, xy_lens, num_heads: int):
    dev = q.device
    ptrs = q.data_ptr(), k.data_ptr(), v.data_ptr(), x_lens.data_ptr(), xy_lens.data_ptr()
    p = launch_plan(meta(q, ptrs[0]), meta(k, ptrs[1]), meta(v, ptrs[2]), meta(x_lens, ptrs[3]),
                    meta(xy_lens, ptrs[4]), num_heads)
    out = q.new_empty(p.out_shape)  # (q's dtype and device; cheaper than torch.empty)
    rc = load_kernels().k4_flash_prefill(*ptrs, out.data_ptr(), error_word(dev).data_ptr(),
                                         p.shape_ptr, cuda_build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {rc}")
    return out


def flash_prefill_attention(q, k, v, x_lens, xy_lens, *, num_heads: int):
    """K4.  q/k/v [B, T, H, Dh] (bf16 or float32, the last dimension
    contiguous, otherwise any strides that keep 16-byte alignment);
    ``x_lens``/``xy_lens`` [B] int32 on the tensors' device.  Returns the
    attention output [B, T, H*Dh] in ``q``'s dtype."""
    for name, t in (("x_lens", x_lens), ("xy_lens", xy_lens)):
        if not isinstance(t, torch.Tensor):
            _fail(f"{name} must be a [{q.shape[0]}] tensor")
    dev = q.device
    if dev.type != "cuda":
        _, T, H, _ = _shapes(tuple(q.shape), tuple(k.shape), tuple(v.shape),
                             tuple(x_lens.shape), tuple(xy_lens.shape), num_heads)
        if dev.type != "cpu":
            _fail(f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")
        if not bool(((x_lens >= 0) & (xy_lens >= 1) & (xy_lens <= T)).all()):
            _fail(f"lengths outside 0 <= xl, 1 <= xyl <= {T}")
        return flash_prefill_attention_ref(q, k, v, x_lens, xy_lens, num_heads=H)
    out = _launch(q, k, v, x_lens, xy_lens, num_heads)
    flash_prefill_attention.launches += 1
    return out


#: kernel launches since the last reset; the twin never counts
flash_prefill_attention.launches = 0
