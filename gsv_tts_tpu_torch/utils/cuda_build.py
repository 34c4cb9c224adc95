"""Build the package's CUDA sources into shared libraries and load them.

Each library is one ``nvcc`` call over ``csrc/*.cu`` with a plain C
interface, bound with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Outputs go to ``gsv_tts_tpu_torch/build/`` under a name carrying
the hash of the sources, the ``csrc/*.cuh`` headers and the flags, so an
edited source is rebuilt and an unchanged one is reused.  Nothing is built
at import time.  Libraries build independently: :func:`load_libraries`
starts one ``nvcc`` per library, all together.

:func:`load_host_library` builds host C++ (``csrc/host/``) the same way with
the host compiler (``$CXX``, else ``c++`` or ``g++`` on ``PATH``), under a
name carrying the hash of the sources, the flags, the compiler's version and
what ``-march=native`` means on this host.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: ``native/Makefile``'s flags, so the library computes what the JAX package's does
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, Optional[ctypes.CDLL]] = {}
#: per host library whose build failed: the error, raised again on every later call
_failed: Dict[str, BaseException] = {}
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


def _lib_lock(name: str) -> threading.Lock:
    with _lock:
        return _lib_locks.setdefault(name, threading.Lock())


def _build_and_load(name: str, key_files: Sequence[Path], key: str, command) -> ctypes.CDLL:
    """``lib<name>-<hash>.so`` (the hash of ``key_files`` and ``key``), built
    with ``command(tmp)`` when missing (into a per-process temporary file, then
    moved in place: concurrent builds never load a half-written file),
    loaded and recorded.  Called under ``name``'s lock."""
    h = hashlib.sha256()
    for p in key_files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(key.encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    built = not out.exists()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = command(tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed building {name} "
                               f"({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    seconds = time.perf_counter() - t0 if built else 0.0
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise RuntimeError(f"loading {out} failed: {e}\n{log}") from e
    build_info[name] = {"path": str(out), "seconds": seconds, "log": log}
    _loaded[name] = lib
    return lib


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>-<hash>.so`` from ``sources``
    (file names under ``csrc/``)."""
    with _lib_lock(name):
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        paths = [CSRC_DIR / s for s in sources]
        return _build_and_load(
            name, paths + sorted(CSRC_DIR.glob("*.cuh")), " ".join(ARCH_FLAGS + NVCC_FLAGS),
            lambda tmp: [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
                         *[str(p) for p in paths]])


def find_cxx() -> Optional[str]:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on ``PATH``;
    ``None`` when there is none."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def _cxx_identity(cxx: str) -> str:
    """The compiler's first ``--version`` line and its expansion of
    ``-march=native`` (a library built for one host's CPU must not be loaded
    on another's)."""
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    march = subprocess.run([cxx, "-march=native", "-E", "-v", "-"], input="",
                           capture_output=True, text=True, timeout=60)
    cc1 = [line for line in march.stderr.splitlines() if "-march=" in line]
    return (version.stdout.splitlines() or [""])[0] + "\n" + (cc1[0] if cc1 else "")


def load_host_library(name: str, sources: Sequence[str]) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load ``lib<name>-<hash>.so`` from host C++
    ``sources`` (paths under ``csrc/``, or absolute) with :data:`CXX_FLAGS`.
    Returns ``None``, with one warning, when no host compiler is found; a
    failed compile or load raises with the compiler's log, and that error is
    raised again on every later call without compiling again."""
    with _lib_lock(name):
        if name in _failed:
            raise _failed[name]
        if name in _loaded:
            return _loaded[name]
        cxx = find_cxx()
        if cxx is None:
            logger.warning("no host C++ compiler ($CXX, c++ or g++ on PATH): %s is not built "
                           "and its callers take their numpy paths", name)
            _loaded[name] = None
            return None
        paths = [CSRC_DIR / s for s in sources]
        try:
            return _build_and_load(
                name, paths, " ".join(CXX_FLAGS) + "\n" + _cxx_identity(cxx),
                lambda tmp: [cxx, *CXX_FLAGS, "-o", str(tmp), *[str(p) for p in paths]])
        except RuntimeError as e:
            _failed[name] = e
            raise


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
