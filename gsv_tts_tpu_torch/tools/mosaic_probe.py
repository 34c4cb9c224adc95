"""P2: the reduction and mask constructs of the decode kernels' per-row
online softmax, on the card (counterpart of the TPU probe
``tools/mosaic_probe.py``, which held each construct alone to see whether
Mosaic lowers it).

x [B * BLOCK, H] = [256, 16] float32 -> [1, H]; x is also read as
[B, BLOCK, H] with the fixed lengths 10 / 20 / 30 / 40:

    baseline   max + sum over all rows (2-D only)
    reduce3d   max + sum over each block's rows, block 0
    bcastcmp   block 0's sum with rows at or past its length set to -1e9
    combined   three loop passes: y = x + acc[0, 0]; m = each block's max of
               y (before the mask); acc += block 0's sum of exp(y - m) over
               its rows below the length

    python -m gsv_tts_tpu_torch.tools.mosaic_probe                 # each variant in a subprocess
    python -m gsv_tts_tpu_torch.tools.mosaic_probe reduce3d        # one, in this process
    python -m gsv_tts_tpu_torch.tools.mosaic_probe --device cpu    # the twins

The TPU tool's ``--interpret`` has no counterpart: ``--device cpu`` runs the
twins.  The kernel is ``csrc/p2_mosaic_probe.cu``: one block of 4 warps, warp
``b`` on block ``b``, x read once into registers, each block's max and sum a
shuffle tree in a fixed order, one barrier a pass of ``combined``.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..utils import cuda_build
from . import card, count_launch, in_subprocesses, launched, load_kernels, parse_cli

B, BLOCK, H = 4, 64, 16
LENS = (10, 20, 30, 40)
VARIANTS = ("baseline", "reduce3d", "bcastcmp", "combined")
#: ``run_variant``'s bound on the error against a float64 evaluation,
#: relative to max(1, |ref|): float32 sums of at most 256 terms in another
#: order (bcastcmp's -5.4e10 carries an absolute rounding of ~1e4, 2e-7 of it)
REL_TOL = 1e-5


def make_input(seed: int = 0) -> np.ndarray:
    """The TPU probe's input: ``RandomState(seed).randn(B * BLOCK, H)``."""
    return np.random.RandomState(seed).randn(B * BLOCK, H).astype(np.float32)


def mosaic_reduce_plain(x: torch.Tensor, variant: str) -> torch.Tensor:
    """The twin, in ``x``'s dtype, on ``x``'s device."""
    if variant == "baseline":
        return x.max(dim=0, keepdim=True).values + x.sum(dim=0, keepdim=True)
    x3 = x.reshape(B, BLOCK, H)
    if variant == "reduce3d":
        return (x3.max(dim=1).values + x3.sum(dim=1))[0:1]
    rows = torch.arange(BLOCK, device=x.device).reshape(1, BLOCK, 1)
    mask = rows < torch.tensor(LENS, device=x.device).reshape(B, 1, 1)
    if variant == "bcastcmp":
        return torch.where(mask, x3, torch.full_like(x3, -1e9)).sum(dim=1)[0:1]
    acc = torch.zeros((1, H), dtype=x.dtype, device=x.device)
    for _ in range(3):
        y = (x + acc[0, 0]).reshape(B, BLOCK, H)
        e = torch.exp(y - y.max(dim=1, keepdim=True).values)
        acc = acc + torch.where(mask, e, torch.zeros_like(e)).sum(dim=1)[0:1]
    return acc


def _checked(x: torch.Tensor, variant: str) -> torch.device:
    if variant not in VARIANTS:
        raise ValueError(f"mosaic_reduce: variant {variant!r}, one of {VARIANTS}")
    if tuple(x.shape) != (B * BLOCK, H) or x.dtype != torch.float32:
        raise ValueError(f"mosaic_reduce: x {tuple(x.shape)} {x.dtype}, want "
                         f"[{B * BLOCK}, {H}] float32")
    return x.device


def _on_card(x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"mosaic_reduce: x on {x.device}: the kernel runs on CUDA, the twin "
                         f"on CPU")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("mosaic_reduce: x must be contiguous and 16-byte aligned")
    return x.device


def mosaic_reduce(x: torch.Tensor, variant: str) -> torch.Tensor:
    """P2.  x [256, 16] float32 -> [1, 16] float32.  A CUDA tensor
    (contiguous, 16-byte aligned) launches the kernel; a CPU tensor runs the
    twin."""
    if _checked(x, variant).type == "cpu":
        return mosaic_reduce_plain(x, variant)
    dev = _on_card(x)
    out = torch.empty((1, H), dtype=torch.float32, device=dev)
    rc = load_kernels().p2_mosaic_probe(x.data_ptr(), out.data_ptr(), VARIANTS.index(variant),
                                        cuda_build.stream_handle(dev))
    launched(rc, "P2")
    count_launch(mosaic_reduce)
    return out


#: kernel launches since the last reset (none under a CUDA graph capture);
#: the twin never counts
mosaic_reduce.launches = 0


def reference(x: np.ndarray, variant: str) -> np.ndarray:
    """The twin in float64 (numpy), the yardstick of ``run_variant``."""
    return mosaic_reduce_plain(torch.from_numpy(x).double(), variant).numpy()


def run_variant(variant: str, device="cuda") -> float:
    """Run one variant on the probe's input, check it against the float64
    reference and print ``{variant}: OK [first three values]``; returns the
    error relative to max(1, |ref|) (raises past :data:`REL_TOL`)."""
    dev = card(device)
    x = make_input(0)
    out = mosaic_reduce(torch.from_numpy(x).to(dev), variant).cpu().double().numpy()
    want = reference(x, variant)
    err = float((np.abs(out - want) / np.maximum(1.0, np.abs(want))).max())
    if not err < REL_TOL:
        raise RuntimeError(f"{variant}: error {err:.3e} against float64 exceeds {REL_TOL:.0e}")
    print(f"{variant}: OK {out.ravel()[:3]} (err {err:.1e})", flush=True)
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
