"""Measurement probes on the card: the counterparts of the TPU probes under
the repository's ``tools/`` (``int4_probe.py``, ``mosaic_probe.py``,
``stream_probe.py``).  Each is a hand-written CUDA kernel
(``csrc/p1_int4_probe.cu``, ``p2_mosaic_probe.cu``, ``p3_stream_probe.cu``,
one library) with a plain PyTorch twin beside its wrapper, and a command:

    python -m gsv_tts_tpu_torch.tools.int4_probe [unpack|unpack_dma] [--device cpu]
    python -m gsv_tts_tpu_torch.tools.mosaic_probe [variant ...] [--device cpu]
    python -m gsv_tts_tpu_torch.tools.stream_probe [variant ...] [--device cpu]

The card is the default and a probe raises without one; ``--device cpu``
runs the twins.  Nothing here imports JAX or the repository's ``tools/``.
"""
from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

import torch

from ..utils import cuda_build

#: (library name, sources) for ``cuda_build``
PROBES_LIBRARY = ("gsv_probes", ["p1_int4_probe.cu", "p2_mosaic_probe.cu", "p3_stream_probe.cu"])
#: dynamic shared memory a block may opt in to on sm_90 (``SMEM_OPTIN`` in
#: ``csrc/bulk_copy.cuh``), which the probes' plans must fit
MAX_SMEM = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (first call only) and bind the three probes' entries."""
    lib = cuda_build.load_library(*PROBES_LIBRARY)
    for fn, args in ((lib.p1_int4_unpack_matmul, [_P] * 6 + [_I] * 8 + [_P]),
                     (lib.p2_mosaic_probe, [_P, _P, _I, _P]),
                     (lib.probe_empty, [_P]),
                     (lib.p3_stream_ring, [_P] * 5 + [_I] * 6 + [_P]),
                     (lib.p3_stream_grid, [_P] * 4 + [_I] * 3 + [_P])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


_err_words: dict = {}


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """The card's SMs (``cudaDevAttrMultiProcessorCount``, as PyTorch reads it)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def empty_launch(dev: torch.device) -> None:
    """Launch the empty kernel (``csrc/p2_mosaic_probe.cu:probe_empty``: one
    block of 128 threads, as P2 launches) on ``dev``'s current stream.  Its
    device time is the launch floor that P1's small shapes and P2 are read
    against; nothing but the smoke calls it, and it counts nothing."""
    launched(load_kernels().probe_empty(cuda_build.stream_handle(dev)), "the empty kernel")


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` unless the current stream is being
    captured into a CUDA graph, where nothing launches (a replay launches
    what was captured: its caller counts that)."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1


def error_word(dev: torch.device) -> torch.Tensor:
    """The probes' error word on ``dev``: a wait on a bulk copy that gave up
    sets bit 1 (the launch's results are void)."""
    err = _err_words.get(dev)
    if err is None:
        err = _err_words[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return err


def check(dev: torch.device) -> None:
    """Raise if a probe launched on ``dev`` gave up a wait (reads one int
    from the card: call it where the host synchronises anyway)."""
    err = _err_words.get(dev)
    if err is not None and int(err.item()):
        err.zero_()
        raise RuntimeError("a probe kernel's wait on its bulk copy gave up; its results are void")


def launched(rc: int, what: str) -> None:
    """Raise on a refused launch (the CUDA error an entry returns)."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def card(device) -> torch.device:
    """The device a probe runs on: ``"cpu"`` runs the twins; anything else
    must be a CUDA card that is there (a probe never falls back)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: the probes run on a CUDA card or, as twins, the CPU")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the probe kernels need one (--device cpu runs the twins)")
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


def parse_cli(argv, default):
    """(variants, device) of a probe's command line: variant names and
    ``--device <device>`` (the card unless told otherwise)."""
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        if i + 1 == len(args):
            raise SystemExit("--device needs a value (cuda or cpu)")
        device = args[i + 1]
        del args[i:i + 2]
    return args or list(default), device


def in_subprocesses(module: str, variants, device: str, timeout: float) -> int:
    """Run ``python -m <module> <variant> --device <device>`` for each
    variant in turn, each under a hard ``timeout`` (seconds), so that a hang
    costs only its own process; print each one's result line (its last line
    of output) and, where it failed, the end of its errors.  Returns 1 if any
    failed or timed out, else 0."""
    root = Path(__file__).resolve().parents[2]
    rc = 0
    for v in variants:
        try:
            r = subprocess.run([sys.executable, "-m", module, v, "--device", device],
                               timeout=timeout, capture_output=True, text=True, cwd=root)
        except subprocess.TimeoutExpired:
            print(f"{v}: TIMEOUT after {timeout:.0f} s (a wait that never completed?)", flush=True)
            rc = 1
            continue
        lines = r.stdout.strip().splitlines()
        print(lines[-1] if lines else f"{v}: no output", flush=True)
        if r.returncode != 0:
            print(f"{v}: exit code {r.returncode}\n{r.stderr[-2000:]}", flush=True)
            rc = 1
    return rc
