"""Build the package's CUDA sources into shared libraries and load them.

Each library is one ``nvcc`` call over ``csrc/*.cu`` with a plain C
interface, bound with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Outputs go to ``gsv_tts_tpu_torch/build/`` under a name carrying
the hash of the sources, the ``csrc/*.cuh`` headers and the flags, so an
edited source is rebuilt and an unchanged one is reused.  Nothing is built
at import time.  Libraries build independently: :func:`load_libraries`
starts one ``nvcc`` per library, all together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
#: per library: {"path", "seconds" (0.0 when reused), "log" (nvcc output)}
build_info: Dict[str, dict] = {}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>-<hash>.so`` from ``sources``
    (file names under ``csrc/``)."""
    with _lock:
        lib_lock = _lib_locks.setdefault(name, threading.Lock())
    with lib_lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        paths = [CSRC_DIR / s for s in sources]
        h = hashlib.sha256()
        for p in paths + sorted(CSRC_DIR.glob("*.cuh")):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
        out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        log = ""
        built = not out.exists()
        if built:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
                   *[str(p) for p in paths]]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {name} ({proc.returncode}):\n{log}")
            os.replace(tmp, out)
        seconds = time.perf_counter() - t0 if built else 0.0
        lib = ctypes.CDLL(str(out))
        build_info[name] = {"path": str(out), "seconds": seconds, "log": log}
        _loaded[name] = lib
        return lib


def stream_handle(dev) -> int:
    """The ``cudaStream_t`` of PyTorch's current stream on ``dev`` (a CUDA
    ``torch.device`` with its index), as an int for a ctypes call.
    ``torch.cuda.current_stream(dev).cuda_stream`` gives the same handle but
    builds a ``Stream`` object first, which costs a launch wrapper more host
    time than the launch itself.  ``_cuda_getCurrentRawStream`` is a private
    binding of PyTorch: should a release drop it, every launch fails here
    with an ``AttributeError``, and the public form above replaces it."""
    import torch

    return torch._C._cuda_getCurrentRawStream(dev.index)


def load_libraries(specs: Sequence[Tuple[str, Sequence[str]]]) -> List[ctypes.CDLL]:
    """Build and load several ``(name, sources)`` libraries at once, one
    ``nvcc`` process each, all started together."""
    with ThreadPoolExecutor(max_workers=max(len(specs), 1)) as pool:
        return list(pool.map(lambda spec: load_library(*spec), specs))
