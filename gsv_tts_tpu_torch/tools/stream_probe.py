"""P3: how fast the card streams a decode step's weight pages with trivial
compute (counterpart of the TPU probe ``tools/stream_probe.py``).

Every variant reads all of w [L, D, W] = [24, 512, 6144] bf16 (150,994,944
bytes, the flagship t2s layers' traffic) once a step, seen as pages of
``rows`` rows, and computes y = sum over pages p of x @ w_p over all W
columns; a step's result is [2, rows] float32: row 0 is y[:rows] (the TPU
kernels' sum_p x @ w_p[:, :rows]), row 1 is y folded by ``rows`` (the TPU
tool's ``xla`` step at rows = D), so every byte enters it:

    fori       the port's own copy mechanism: one block per SM streams its
               rows of every page of ``rows`` = D rows through a two-slot ring
               of 1-D bulk asynchronous copies on mbarriers
               (``csrc/p3_stream_probe.cu``, built from ``bulk_copy.cuh`` as
               K1's weight ring is)
    fori<N>    the same over pages of N rows (256, 1024, 2048): larger pages,
               fewer and larger copies
    grid       a plain grid of (row tile, layer) blocks loading with 16-byte
               loads, no asynchronous copy: occupancy alone overlaps them
    xla        plain PyTorch, the library yardstick: one ``torch.matmul`` of
               x repeated L times against w as [L * D, W] (bf16 in, float32
               sums, bf16 out on the card)
    k1ring     (the port's own) pages of D rows through K1's ring: 8 slots,
               each copy the whole rows that fit K1's 16 KB stage

A step feeds ``tanh`` of its TPU counterpart's result (row 0; ``xla``'s row
1) back as the next x, as bf16; the REPS-step chain is captured in one CUDA
graph and replayed ROUNDS times (the TPU tool's one ``lax.scan`` in one
``jit``).  Each line gives the best round's ms a step, the rate over w's
bytes, the time a page, every round, and the bound: the function's bytes
over the card's 3.35 TB/s.

    python -m gsv_tts_tpu_torch.tools.stream_probe              # VARIANTS, a subprocess each
    python -m gsv_tts_tpu_torch.tools.stream_probe fori1024     # one, in this process
    python -m gsv_tts_tpu_torch.tools.stream_probe fori --device cpu   # the twin (host time)
"""
from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..utils import cuda_build
from . import (MAX_SMEM, card, check, count_launch, error_word, in_subprocesses, launched,
               load_kernels, parse_cli, sm_count)

L, D, W = 24, 512, 6144
REPS = 100  # steps chained in one graph
ROUNDS = 3  # timed replays per variant (each reported; the best is the result)
DEFAULT = ["xla", "fori", "grid", "fori256", "fori1024", "fori2048"]  # the TPU tool's
VARIANTS = DEFAULT + ["k1ring"]
#: the card's published memory rate (NVIDIA H100 SXM), for the bound
HBM_BYTES_PER_S = 3.35e12
#: the kernels' fixed widths (``csrc/p3_stream_probe.cu``): ring threads,
#: the 4-column groups one owns, the ring's barrier area; grid rows a block,
#: its threads and the 16-byte vectors of a row one owns
RING_THREADS, RING_MAX_GROUPS, RING_HEAD = 512, 4, 128
GRID_TILE, GRID_THREADS, GRID_VECS = 32, 256, 4
#: K1's weight ring (``PS_STAGES``, ``PS_STAGE_BYTES`` in
#: ``csrc/decode_step_persistent.cuh``)
K1_STAGES, K1_STAGE_BYTES = 8, 16384
#: a step's tolerance against the twin, relative to max |twin|: float32 sums
#: of the same products in other orders
REL_TOL = 1e-4


def rows_of(variant: str, d: int) -> int:
    """Rows a page (and the width of x and of the result) of ``variant`` over
    a w of ``d`` rows a layer."""
    if variant in ("fori", "grid", "xla", "k1ring"):
        return d
    if variant.startswith("fori") and variant[4:].isdigit():
        return int(variant[4:])
    raise ValueError(f"stream_probe: unknown variant {variant!r}")


def make_inputs(rows: int, seed: int = 0):
    """The TPU probe's data (``tools/stream_probe.py:164-169``) on the CPU:
    w [L, D, W] and x0 [1, rows], bf16.  ``RandomState.randn`` draws one
    value after another, so x0 for fewer rows is a prefix of x0 for more."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(L, D, W).astype(np.float32) * 0.02).to(torch.bfloat16)
    x0 = torch.from_numpy(rng.randn(1, rows).astype(np.float32) * 0.1).to(torch.bfloat16)
    return w, x0


class RingPlan(NamedTuple):
    blocks: int           # one an SM
    share: int            # the most rows of a page a block owns
    stages: int           # slots of the ring
    chunk_rows: int       # rows a copy moves (a slot's rows)
    copy_bytes: int       # bytes of a full copy
    copies_per_page: int  # copies (and waits) of a block's share of a page
    smem: int             # dynamic shared memory a block asks for


def ring_plan(variant: str, rows: int, width: int, blocks: int) -> RingPlan:
    """How a ring variant streams, in copies of whole rows (never a shorter
    page).  ``fori<rows>``: two slots, each block's share of a page in as few
    copies as two slots allow; ``k1ring``: K1's ring, 8 slots, each copy the
    rows that fit K1's 16 KB stage (at least one)."""
    share = -(-rows // blocks)
    row_bytes = 2 * width
    if variant == "k1ring":
        stages, chunk = K1_STAGES, max(1, K1_STAGE_BYTES // row_bytes)
    else:
        stages = 2
        chunk = min(share, (MAX_SMEM - RING_HEAD - 4 * share) // (stages * row_bytes))
    smem = RING_HEAD + max(stages * chunk * row_bytes, 4 * width) + 4 * share
    if chunk < 1 or smem > MAX_SMEM:
        raise ValueError(f"stream_probe: {variant}: {stages} slots of {row_bytes}-byte rows do "
                         f"not fit shared memory")
    return RingPlan(blocks, share, stages, chunk, chunk * row_bytes, -(-share // chunk), smem)


def _shapes(x, w, variant):
    if w.dim() != 3 or x.dim() != 2 or x.shape[0] != 1:
        raise ValueError(f"stream_step: w {tuple(w.shape)} must be [L, D, W], x {tuple(x.shape)} "
                         f"[1, rows]")
    n_l, d, width = w.shape
    rows = rows_of(variant, d)
    if x.shape[1] != rows or (n_l * d) % rows or width % rows:
        raise ValueError(f"stream_step: {variant} over w {tuple(w.shape)} takes x [1, {rows}], "
                         f"pages of {rows} whole rows and W a multiple of {rows}, "
                         f"got x {tuple(x.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"stream_step: dtypes {x.dtype}, {w.dtype}: want bfloat16")
    return n_l, d, width, rows


def _head_and_fold(y, rows: int):
    """y [1, W] float32 -> [2, rows]: y[:rows] and y folded by ``rows``."""
    return torch.cat([y[:, :rows], y.reshape(-1, rows).sum(dim=0, keepdim=True)])


def xla_step(x, w):
    """The probe's library step: y = x repeated over the pages times w as
    [pages * rows, W] in one matmul (bf16 in, float32 sums; on the CPU in
    float32), then [2, rows] as the kernels give it."""
    rows, width = x.shape[1], w.shape[2]
    xr = x.repeat(1, w.numel() // (rows * width))
    w2 = w.reshape(-1, width)
    y = xr.float() @ w2.float() if w.device.type == "cpu" else torch.matmul(xr, w2).float()
    return _head_and_fold(y, rows)


def stream_step_plain(x, w, variant: str):
    """The twin of every variant: y = sum over pages of x @ w_p in float32,
    as [2, rows]."""
    n_l, d, width, rows = _shapes(x, w, variant)
    wp = w.reshape(n_l * d // rows, rows, width).float()
    y = torch.einsum("k,pkc->c", x.reshape(rows).float(), wp).reshape(1, width)
    return _head_and_fold(y, rows)


def result(out, variant: str):
    """The row of a step's [2, rows] that the TPU tool's ``variant`` returns
    (``xla``'s fold, the kernels' head), as [1, rows]: what the chain feeds."""
    return out[1:2] if variant == "xla" else out[0:1]


def stream_step(x, w, variant: str):
    """One step of ``variant``: x [1, rows] bf16, w [L, D, W] bf16 ->
    [2, rows] float32.  On CUDA tensors (contiguous, 16-byte aligned) the
    ``fori*``, ``k1ring`` and ``grid`` variants launch their kernels; on CPU
    tensors they run the twin; ``xla`` is plain PyTorch on either."""
    n_l, d, width, rows = _shapes(x, w, variant)
    if variant == "xla":
        return xla_step(x, w)
    dev = w.device
    if dev.type == "cpu" and x.device == dev:
        return stream_step_plain(x, w, variant)
    if dev.type != "cuda":
        raise ValueError(f"stream_step: tensors on {dev}: the kernels run on CUDA, the twin on CPU")
    for name, t in (("x", x), ("w", w)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"stream_step: {name} must be contiguous, 16-byte aligned and on {dev}")
    if width % 8:
        raise ValueError(f"stream_step: W = {width} must be a multiple of 8 (16-byte rows)")
    lib, stream = load_kernels(), cuda_build.stream_handle(dev)
    out = torch.empty((2, rows), dtype=torch.float32, device=dev)
    if variant == "grid":
        if d % GRID_TILE or width > 8 * GRID_THREADS * GRID_VECS:
            raise ValueError(f"stream_step: grid takes D a multiple of {GRID_TILE} and W up to "
                             f"{8 * GRID_THREADS * GRID_VECS}, got {d}, {width}")
        partial = torch.empty((n_l * d // GRID_TILE, 2, d), dtype=torch.float32, device=dev)
        rc = lib.p3_stream_grid(w.data_ptr(), x.data_ptr(), partial.data_ptr(), out.data_ptr(),
                                n_l, d, width, stream)
    else:
        if width > 4 * RING_THREADS * RING_MAX_GROUPS:
            raise ValueError(f"stream_step: {variant}: W up to {4 * RING_THREADS * RING_MAX_GROUPS}")
        plan = ring_plan(variant, rows, width, sm_count(dev))
        partial = torch.empty((plan.blocks, 2, rows), dtype=torch.float32, device=dev)
        rc = lib.p3_stream_ring(w.data_ptr(), x.data_ptr(), partial.data_ptr(), out.data_ptr(),
                                error_word(dev).data_ptr(), n_l * d // rows, rows, width,
                                plan.stages, plan.chunk_rows, plan.blocks, stream)
    launched(rc, f"P3 {variant}")
    count_launch(stream_step)
    return out


#: kernel steps launched since the last reset (two launches each: the stream
#: and the reduction), eager or replayed from a graph (``time_chain`` adds
#: its replays); the twin and ``xla`` never count
stream_step.launches = 0


def chain(x, w, variant: str, reps: int):
    """``reps`` steps, each feeding tanh of its result back as x."""
    for _ in range(reps):
        x = torch.tanh(result(stream_step(x, w, variant), variant)).to(torch.bfloat16)
    return x


def time_chain(x0, w, variant: str) -> list:
    """ms a step of each of ROUNDS runs of the REPS-step chain: on the card,
    replays of one CUDA graph timed by events; on the CPU, the host clock."""
    dev = w.device
    if dev.type == "cpu":
        times = []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            chain(x0, w, variant, REPS)
            times.append(1e3 * (time.perf_counter() - t0) / REPS)
        return times
    chain(x0, w, variant, REPS)  # warm: the build, the first launches
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain(x0, w, variant, REPS)
    times = []
    for _ in range(ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end) / REPS)
        if variant != "xla":  # the replay launched the captured steps
            stream_step.launches += REPS
    check(dev)
    return times


def bound_ms(variant: str, n_l: int, d: int, width: int) -> float:
    """The least time a step can take on the card: the bytes its function
    must move (w and x read once, the [2, rows] result written once) over
    the memory rate; its 2 * L * D * W float32 operations take 1/20 of it."""
    rows = rows_of(variant, d)
    return 1e3 * (2 * n_l * d * width + 2 * rows + 4 * 2 * rows) / HBM_BYTES_PER_S


def run_variant(variant: str, device="cuda", inputs=None) -> dict:
    """Hold one step of ``variant`` against its twin (kernel variants), time
    the chain and print the line; returns the numbers.  ``inputs`` = (w, x)
    from :func:`make_inputs` (x at least as wide as the variant's rows) on
    the device spares building them again."""
    dev = card(device)
    w, x = inputs if inputs is not None else make_inputs(rows_of(variant, D))
    rows = rows_of(variant, w.shape[1])
    w, x0 = w.to(dev), x[:, :rows].contiguous().to(dev)
    n_l, d, width, _ = _shapes(x0, w, variant)
    err = 0.0
    if variant != "xla":
        got = stream_step(x0, w, variant)
        want = stream_step_plain(x0, w, variant)
        err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
        if not err < REL_TOL:
            raise RuntimeError(f"{variant}: a step is {err:.3e} from its twin (relative), "
                               f"past {REL_TOL:.0e}")
    times = time_chain(x0, w, variant)
    best = min(times)
    n_bytes = 2 * w.numel()
    pages = n_l * d // rows
    res = {"variant": variant, "ms": best, "rounds": times, "pages": pages, "bytes": n_bytes,
           "gb_s": n_bytes / (best * 1e-3) / 1e9, "bound_ms": bound_ms(variant, n_l, d, width),
           "rel_err": err, "device": str(dev)}
    line = (f"{variant}: {best:.4f} ms/step  {res['gb_s']:.0f} GB/s  "
            f"({1e3 * best / pages:.2f} us/page x {pages})  "
            f"[rounds {'/'.join(f'{t:.4f}' for t in times)}]  bound {res['bound_ms']:.4f} ms")
    if variant not in ("xla", "grid") and dev.type == "cuda":
        plan = ring_plan(variant, rows, width, sm_count(dev))
        res.update(copy_bytes=plan.copy_bytes, stages=plan.stages,
                   copies_per_page=plan.copies_per_page, blocks=plan.blocks)
        line += (f"  {plan.blocks} blocks, {plan.stages} slots of {plan.copy_bytes} B, "
                 f"{plan.copies_per_page} copies a page a block, one wait a copy")
    if dev.type == "cpu":
        line += "  (the twin on the CPU: host time, not a device time)"
    print(line, flush=True)
    return res


def main(argv=None) -> int:
    variants, device = parse_cli(argv, VARIANTS)
    for v in variants:
        rows_of(v, D)
    if len(variants) == 1:
        run_variant(variants[0], device)
        return 0
    return in_subprocesses(__spec__.name, variants, device, timeout=600)


if __name__ == "__main__":
    sys.exit(main())
