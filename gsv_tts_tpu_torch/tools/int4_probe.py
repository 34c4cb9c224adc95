"""P1: the int4 nibble unpack and its product on the card (counterpart of the
TPU probe ``tools/int4_probe.py``).

    b   = packed.int32;  hi = b >> 4;  lo = ((b & 15) ^ 8) - 8
    w   = cat([lo, hi], dim=1).bf16                  [D, N]
    out = (bf16(x) @ w, float32 sums) * scale         [8, N]

Byte column ``j`` of ``packed`` [D, N/2] holds output column ``j`` in its low
nibble and ``j + N/2`` in its high one.  Variants: ``unpack`` (the kernel
reads its bytes from global memory into registers) and ``unpack_dma`` (the
bytes stream through a ring of shared-memory slots filled by bulk
asynchronous copies on mbarriers).  The kernel (``csrc/p1_int4_probe.cu``)
unpacks in registers and multiplies on the tensor cores over the whole card;
:func:`plan` lays its grid out.

    python -m gsv_tts_tpu_torch.tools.int4_probe              # each variant in a subprocess
    python -m gsv_tts_tpu_torch.tools.int4_probe unpack       # one, in this process
    python -m gsv_tts_tpu_torch.tools.int4_probe --device cpu # the twin

A subprocess per variant under a hard timeout, as on the TPU: a wait that
never completes would hang the process that launched it (the kernel gives up
after 2^22 polls, but a probe of a new construct is run where a hang costs
nothing).
"""
from __future__ import annotations

import functools
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import cuda_build
from . import (MAX_SMEM, card, check, count_launch, error_word, in_subprocesses, launched,
               load_kernels, parse_cli, sm_count)

D, N = 256, 512  # contraction rows x output columns (N/2 packed bytes a row)
VARIANTS = ("unpack", "unpack_dma")
#: rows of x and of the output, fixed by the kernel
X_ROWS = 8
#: the largest relative error ``run_variant`` accepts: the kernel and the
#: reference sum the same exact bf16 products in float32 in other orders
#: (~1e-7 relative), where the TPU probe allowed 1e-2
REL_TOL = 1e-5
#: the s1v3 layer stack as one int4 page: P3's [24, 512, 6144] weights,
#: 24 x 512 rows deep (the smoke's third shape)
STACK = (24 * 512, 6144)

# The kernel's constants (``csrc/p1_int4_probe.cu``).
#: warps of a block
WARPS = 8
#: byte columns of a warp: 16 for each of its 8 lane groups
WARP_BYTES = 128
#: bytes after each row of a ring slot (``P1_RING_PAD``)
RING_PAD = 32
#: the warps' sums in shared memory (``P1_SCRATCH``): 8 warps x 8 rows x 260 floats
SCRATCH = WARPS * X_ROWS * (2 * WARP_BYTES + 4) * 4
#: ``unpack_dma``'s ring: at most this many slots (16 KB of packed bytes each)
RING = 4
#: a block's column tile by variant: the first of these warp counts whose
#: tile (128 bytes a warp) divides N/2.  ``unpack`` one warp (the most
#: tiles, so the fewest splits and partials).  ``unpack_dma``'s copies are a
#: tile's row each, and their size sets the ring's rate
COL_WARPS = {"unpack": (1,), "unpack_dma": (8, 4, 2, 1)}
#: the fewest stages a split of D takes: below it a block's fixed costs (x's
#: slice, its sums) outweigh what it streams
MIN_STAGES = 4
#: blocks an SM holds by variant: ``unpack`` keeps its bytes in flight in
#: registers, so two blocks an SM; ``unpack_dma`` in its ring, so one
BLOCKS_PER_SM = {"unpack": 2, "unpack_dma": 1}
#: SMs of the H100, the plan's default
SMS = 132


@dataclass(frozen=True)
class Plan:
    """A launch of the kernel: a block (8 warps) takes one of ``tiles``
    column tiles of ``tile`` bytes and one of ``splits`` runs of D's rows,
    walked in stages of ``stage_rows`` (16 rows a warp of the tile's
    ``k_warps``); ``unpack_dma`` streams them through ``ring`` slots."""
    d: int
    half: int
    col_warps: int   # warps across the column tile
    stages: int      # stages in D, the last one short where D asks
    splits: int
    ring: int        # unpack_dma's slots; 0 for unpack
    xs: int          # a row of a block's staged x slice, in bf16 elements

    @property
    def k_warps(self) -> int:
        return WARPS // self.col_warps

    @property
    def tile(self) -> int:
        return WARP_BYTES * self.col_warps

    @property
    def tiles(self) -> int:
        return self.half // self.tile

    @property
    def stage_rows(self) -> int:
        return 16 * self.k_warps

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def split_rows(self, s: int):
        """Rows [lo, hi) of D that split ``s`` takes (the kernel's formula:
        stages // splits stages a split, one more for the first
        stages % splits)."""
        per, extra = divmod(self.stages, self.splits)
        st0 = s * per + min(s, extra)
        st1 = st0 + per + (s < extra)
        return st0 * self.stage_rows, min(st1 * self.stage_rows, self.d)

    @property
    def smem(self) -> int:
        """Dynamic shared memory of a block (``p1_smem``): the ring (at least
        the warps' sums, which reuse it), x's slice, the ring's mbarriers."""
        slots = self.ring * self.stage_rows * (self.tile + RING_PAD)
        return max(slots, SCRATCH) + 2 * X_ROWS * self.xs + 8 * self.ring


@functools.lru_cache(maxsize=None)
def plan(d: int, half: int, variant: str = "unpack", sms: int = SMS) -> Plan:
    """The kernel's plan for ``packed`` [d, half] on a card of ``sms`` SMs.

    Column tile: :data:`COL_WARPS` (``unpack`` 128 bytes, ``unpack_dma``
    the widest of 1024 / 512 / 256 / 128 that divides ``half``).
    Splits: enough for ``BLOCKS_PER_SM`` blocks on every SM, but each at
    least ``MIN_STAGES`` stages; one split (no second pass) where D is too
    short for two.  Raises ``ValueError`` for shapes the kernel does not
    take: D a multiple of 16, N/2 of 128."""
    if variant not in VARIANTS:
        _fail(f"variant {variant!r}, one of {VARIANTS}")
    if d < 16 or d % 16:
        _fail(f"D = {d} must be a positive multiple of 16 (the mma's depth)")
    if half < WARP_BYTES or half % WARP_BYTES:
        _fail(f"N/2 = {half} must be a multiple of {WARP_BYTES} (a warp's byte columns)")
    dma = variant == "unpack_dma"
    col_warps = next(c for c in COL_WARPS[variant] if half % (WARP_BYTES * c) == 0)
    tiles = half // (WARP_BYTES * col_warps)
    stage_rows = 16 * (WARPS // col_warps)
    stages = -(-d // stage_rows)
    splits = max(1, min(-(-BLOCKS_PER_SM[variant] * sms // tiles), stages // MIN_STAGES))
    longest = -(-stages // splits) * stage_rows
    xs = -(-longest // 64) * 64 + 16  # 2 * xs = 32 (mod 128) bytes: lanes g meet no bank twice
    ring = min(RING, -(-stages // splits)) if dma else 0
    p = Plan(d, half, col_warps, stages, splits, ring, xs)
    if p.smem > MAX_SMEM:
        _fail(f"plan {p} needs {p.smem} bytes of shared memory, above {MAX_SMEM}")
    return p


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


def _on_card(x, packed, scale):
    """The CUDA device of the three tensors, or raise (the kernel's
    layout: contiguous, 16-byte aligned)."""
    dev = x.device
    if dev.type != "cuda":
        _fail(f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            _fail(f"{name} must be contiguous, 16-byte aligned and on {dev}")
    return dev


def int4_unpack_matmul(x, packed, scale, variant: str = "unpack"):
    """P1.  x [8, D] float32, packed [D, N/2] int8, scale [1, N] float32 ->
    [8, N] float32, D a multiple of 16 and N/2 of 128 (:func:`plan`).  CUDA
    tensors (contiguous, 16-byte aligned) launch the kernel: one launch, or
    two where :func:`plan` splits D; CPU tensors run the twin."""
    if variant not in VARIANTS:
        _fail(f"variant {variant!r}, one of {VARIANTS}")
    d, half = _check(x, packed, scale)
    dev = x.device
    if dev.type == "cpu" and packed.device == dev and scale.device == dev:
        plan(d, half, variant)
        return int4_unpack_matmul_plain(x, packed, scale)
    dev = _on_card(x, packed, scale)
    p = plan(d, half, variant, sm_count(dev))
    out = torch.empty((X_ROWS, 2 * half), dtype=torch.float32, device=dev)
    part = (torch.empty((p.splits, X_ROWS, 2 * half), dtype=torch.float32, device=dev)
            if p.splits > 1 else out)
    rc = load_kernels().p1_int4_unpack_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), part.data_ptr(),
        error_word(dev).data_ptr(), d, half, p.col_warps, p.stages, p.splits, p.ring, p.xs,
        int(variant == "unpack_dma"), cuda_build.stream_handle(dev))
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
