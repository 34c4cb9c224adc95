"""P1: the int4 nibble unpack and its product on the card (counterpart of the
TPU probe ``tools/int4_probe.py``).

    b   = packed.int32;  hi = b >> 4;  lo = ((b & 15) ^ 8) - 8
    w   = cat([lo, hi], dim=1).bf16                  [D, N]
    out = (bf16(x) @ w, float32 sums) * scale         [8, N]

Byte column ``j`` of ``packed`` [D, N/2] holds output column ``j`` in its low
nibble and ``j + N/2`` in its high one.  Variants: ``unpack`` (the kernel
reads its bytes from global memory) and ``unpack_dma`` (the block's bytes
first land in slot 0 of a two-slot shared buffer by bulk asynchronous copies
on an mbarrier); ``csrc/p1_int4_probe.cu`` says what each does on the card.

    python -m gsv_tts_tpu_torch.tools.int4_probe              # each variant in a subprocess
    python -m gsv_tts_tpu_torch.tools.int4_probe unpack       # one, in this process
    python -m gsv_tts_tpu_torch.tools.int4_probe --device cpu # the twin

A subprocess per variant under a hard timeout, as on the TPU: a wait that
never completes would hang the process that launched it (the kernel gives up
after 2^22 polls, but a probe of a new construct is run where a hang costs
nothing).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..utils import cuda_build
from . import (MAX_SMEM, card, check, count_launch, error_word, in_subprocesses, launched,
               load_kernels, parse_cli)

D, N = 256, 512  # contraction rows x output columns (N/2 packed bytes a row)
VARIANTS = ("unpack", "unpack_dma")
#: rows of x and of the output, fixed by the kernel
X_ROWS = 8
#: the largest relative error ``run_variant`` accepts: the kernel and the
#: reference sum the same exact bf16 products in float32 in other orders
#: (~1e-7 relative), where the TPU probe allowed 1e-2
REL_TOL = 1e-5
#: the shared memory a block needs besides the slots and x: the slices' sums
#: (``P1_PART_BYTES`` in ``csrc/p1_int4_probe.cu``)
PART_BYTES = 65536


def make_inputs(seed: int = 0, d: int = D, n: int = N):
    """The TPU probe's data (``tools/int4_probe.py:63-71``): x [8, d] float32,
    q [d, n] int in [-7, 7], packed [d, n/2] int8, scale [1, n] float32."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-7, 8, size=(d, n)).astype(np.int32)
    scale = (rng.rand(1, n).astype(np.float32) + 0.5) * 0.01
    lo, hi = q[:, : n // 2], q[:, n // 2:]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.int8)
    x = rng.randn(X_ROWS, d).astype(np.float32) * 0.1
    return x, q, packed, scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[d, n/2] int8 -> [d, n] bf16: low nibbles, then high nibbles."""
    b = packed.to(torch.int32)
    hi = b >> 4
    lo = ((b & 15) ^ 8) - 8
    return torch.cat([lo, hi], dim=1).to(torch.bfloat16)


def int4_unpack_matmul_plain(x, packed, scale):
    """The twin: the bf16 operands' products summed in float32, then the
    scale.  Both operands are exact in float32, so the product is taken
    there."""
    xb = x.to(torch.bfloat16).float()
    return (xb @ unpack_int4(packed).float()) * scale


def block_cols(d: int, half: int) -> int:
    """Byte columns a block of the kernel takes: the most of 256, 128, ... 16
    that divides ``half`` and leaves two slots of ``d`` rows in shared
    memory (the same for both variants, so that their times compare)."""
    for cols in (256, 128, 64, 32, 16):
        if half % cols == 0 and 2 * d * cols + 4 * X_ROWS * d + PART_BYTES + 16 <= MAX_SMEM:
            return cols
    raise ValueError(f"int4_unpack_matmul: no block width fits D={d}, N/2={half}")


def _fail(msg: str):
    raise ValueError(f"int4_unpack_matmul: {msg}")


def _check(x, packed, scale):
    if x.dim() != 2 or x.shape[0] != X_ROWS or packed.dim() != 2 or packed.shape[0] != x.shape[1]:
        _fail(f"x {tuple(x.shape)} must be [{X_ROWS}, D] and packed {tuple(packed.shape)} [D, N/2]")
    d, half = packed.shape
    if scale.shape not in ((1, 2 * half), (2 * half,)):
        _fail(f"scale {tuple(scale.shape)} must be [1, {2 * half}]")
    if x.dtype != torch.float32 or scale.dtype != torch.float32 or packed.dtype != torch.int8:
        _fail(f"dtypes {x.dtype}, {packed.dtype}, {scale.dtype}: want float32, int8, float32")
    return d, half


def int4_unpack_matmul(x, packed, scale, variant: str = "unpack"):
    """P1.  x [8, D] float32, packed [D, N/2] int8, scale [1, N] float32 ->
    [8, N] float32.  CUDA tensors launch the kernel (contiguous, 16-byte
    aligned, N/2 a multiple of 16); CPU tensors run the twin."""
    if variant not in VARIANTS:
        _fail(f"variant {variant!r}, one of {VARIANTS}")
    d, half = _check(x, packed, scale)
    dev = x.device
    if dev.type == "cpu" and packed.device == dev and scale.device == dev:
        return int4_unpack_matmul_plain(x, packed, scale)
    if dev.type != "cuda":
        _fail(f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            _fail(f"{name} must be contiguous, 16-byte aligned and on {dev}")
    if half % 16:
        _fail(f"N/2 = {half} must be a multiple of 16 (whole 16-byte runs a row)")
    cols = block_cols(d, half)
    out = torch.empty((X_ROWS, 2 * half), dtype=torch.float32, device=dev)
    rc = load_kernels().p1_int4_unpack_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        error_word(dev).data_ptr(), d, half, cols, int(variant == "unpack_dma"),
        cuda_build.stream_handle(dev))
    launched(rc, "P1")
    count_launch(int4_unpack_matmul)
    return out


#: kernel launches since the last reset (none under a CUDA graph capture);
#: the twin never counts
int4_unpack_matmul.launches = 0


def reference(x, q, scale):
    """The TPU probe's check (``:95-99``): the float32 product of the
    bf16-rounded x and the integer weights, times the scale."""
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    return (xb @ q.astype(np.float64)) * scale.astype(np.float64)


def run_variant(variant: str, device="cuda") -> float:
    """Run one variant at the probe's shapes, check it against the reference
    and print ``{variant}: rel_err=... PASS``; returns the relative error
    (raises if it exceeds :data:`REL_TOL`)."""
    dev = card(device)
    x, q, packed, scale = make_inputs(0)
    args = [torch.from_numpy(a).to(dev) for a in (x, packed, scale)]
    out = int4_unpack_matmul(*args, variant=variant)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        check(dev)
    want = reference(x, q, scale)
    err = float(np.abs(out.cpu().double().numpy() - want).max() / (np.abs(want).max() + 1e-9))
    if not err < REL_TOL:
        raise RuntimeError(f"{variant}: rel_err {err:.3e} exceeds {REL_TOL:.0e}")
    print(f"{variant}: rel_err={err:.3e} PASS", flush=True)
    return err


def main(argv=None) -> int:
    variants, device = parse_cli(argv, VARIANTS)
    for v in variants:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}: one of {VARIANTS}")
    if len(variants) == 1:
        run_variant(variants[0], device)
        return 0
    return in_subprocesses(__spec__.name, variants, device, timeout=240)


if __name__ == "__main__":
    sys.exit(main())
