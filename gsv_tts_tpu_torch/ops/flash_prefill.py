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
stops every row at its last attended column; on CPU tensors it runs the plain
PyTorch twin :func:`flash_prefill_attention_ref`.  There is no fallback
between the two.  ``q``/``k``/``v`` may be strided views (the model passes
slices of the ``[B, T, 3D]`` qkv product); the lengths stay on the device.
Lengths outside ``0 <= xl``, ``1 <= xyl <= T`` give that batch entry NaN and
set a bit in the t2s kernels' error word, which ``ops.fused_step.check``
raises on (it reads one int back, so call it where the host synchronises
anyway).

The twin takes one softmax per row in float32 and rounds the probabilities
to ``v``'s dtype before the value product, as the TPU kernel does; the CUDA
kernel runs an online softmax that keeps them in float32.  In float32 the
two agree to ~1e-6, in bf16 to the rounding of the probabilities.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import cuda_build
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


class _K4Args(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("q", "k", "v", "x_lens", "xy_lens", "out", "err")]
        + [(n, ctypes.c_int) for n in ("B", "T", "H", "Dh", "is_f32")]
        + [(f"{t}_{s}", ctypes.c_longlong) for t in "qkv" for s in ("sb", "st", "sh")]
    )


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (first call only) and bind ``csrc/k4_flash_prefill.cu``."""
    lib = cuda_build.load_library(*LIBRARY)
    lib.k4_flash_prefill.argtypes = [ctypes.POINTER(_K4Args), ctypes.c_void_p]
    lib.k4_flash_prefill.restype = ctypes.c_int
    return lib


def _fail(msg: str):
    raise ValueError(f"flash_prefill_attention: {msg}")


def flash_prefill_attention(q, k, v, x_lens, xy_lens, *, num_heads: int):
    """K4.  q/k/v [B, T, H, Dh] (bf16 or float32, the last dimension
    contiguous, otherwise any strides that keep 16-byte alignment);
    ``x_lens``/``xy_lens`` [B] int32 on the tensors' device.  Returns the
    attention output [B, T, H*Dh] in ``q``'s dtype."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        _fail(f"q/k/v shapes {tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    B, T, H, Dh = q.shape
    if H != num_heads:
        _fail(f"{H} heads in q, num_heads={num_heads}")
    for name, t in (("x_lens", x_lens), ("xy_lens", xy_lens)):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != (B,):
            _fail(f"{name} must be a [{B}] tensor")
    dev = q.device
    if dev.type == "cpu":
        if not bool(((x_lens >= 0) & (xy_lens >= 1) & (xy_lens <= T)).all()):
            _fail(f"lengths outside 0 <= xl, 1 <= xyl <= {T}")
        return flash_prefill_attention_ref(q, k, v, x_lens, xy_lens, num_heads=H)
    if dev.type != "cuda":
        _fail(f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")
    if Dh not in HEAD_DIMS:
        _fail(f"head dim {Dh} must be one of {HEAD_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        _fail(f"dtype {q.dtype}")
    if q.dtype == torch.float32 and Dh > 64:
        _fail(f"float32 with head dim {Dh}: the kernel's float32 tiles hold heads up to 64 wide")
    vec = 16 // q.element_size()  # elements per 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.device == dev and t.dtype == q.dtype and t.stride(3) == 1
                and t.data_ptr() % 16 == 0 and all(t.stride(i) % vec == 0 for i in range(3))):
            _fail(f"{name} must be a {q.dtype} tensor on {dev} with a contiguous last dimension "
                  f"and 16-byte aligned rows (strides {t.stride()})")
    for name, t in (("x_lens", x_lens), ("xy_lens", xy_lens)):
        if not (t.device == dev and t.dtype == torch.int32 and t.is_contiguous()):
            _fail(f"{name} must be a contiguous int32 tensor on {dev}")
    out = torch.empty((B, T, H * Dh), dtype=q.dtype, device=dev)
    a = _K4Args()
    a.q, a.k, a.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    a.x_lens, a.xy_lens = x_lens.data_ptr(), xy_lens.data_ptr()
    a.out, a.err = out.data_ptr(), error_word(dev).data_ptr()
    a.B, a.T, a.H, a.Dh, a.is_f32 = B, T, H, Dh, int(q.dtype == torch.float32)
    for name, t in (("q", q), ("k", k), ("v", v)):
        for s, i in (("sb", 0), ("st", 1), ("sh", 2)):
            setattr(a, f"{name}_{s}", t.stride(i))
    rc = load_kernels().k4_flash_prefill(ctypes.byref(a),
                                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {rc}")
    flash_prefill_attention.launches += 1
    return out


#: kernel launches since the last reset; the twin never counts
flash_prefill_attention.launches = 0
