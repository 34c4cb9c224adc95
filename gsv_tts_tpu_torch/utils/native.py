"""ctypes bridge to the host C++ DSP library (counterpart of
``gsv_tts_tpu/utils/native.py``).

The library (``csrc/host/gsv_native.cpp``, a copy of the JAX package's
``native/gsv_native.cpp``) runs the sequential host algorithms: the SOLA
cross-correlation offset search, the monotonic Viterbi of the subtitles, the
compressor's envelope follower and the Freeverb wet path.  :func:`native_lib`
builds it with the host compiler at first use
(``utils/cuda_build.load_host_library``, into ``gsv_tts_tpu_torch/build/``)
and returns ``None`` when ``GSV_DISABLE_NATIVE`` is set (read on every call)
or no compiler is found; every caller then takes its numpy path.  The
package's own copy of the source always has all four entry points, so they are
bound unconditionally (a missing one fails at bind time).
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

LIBRARY = ("gsv_native", ("host/gsv_native.cpp",))


class _NativeLib:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        #: calls of each entry point, read by tests and the smoke to see which path ran
        self.calls = {"sola_offset": 0, "viterbi_monotonic": 0, "envelope_follow": 0,
                      "freeverb": 0}
        lib.gsv_sola_offset.restype = ctypes.c_int64
        lib.gsv_sola_offset.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.gsv_viterbi_monotonic.restype = None
        lib.gsv_viterbi_monotonic.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.gsv_envelope_follow.restype = None
        lib.gsv_envelope_follow.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.gsv_freeverb.restype = None
        lib.gsv_freeverb.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double),
        ]

    def sola_offset(self, query: np.ndarray, key: np.ndarray, overlap_len: int) -> int:
        self.calls["sola_offset"] += 1
        query = np.ascontiguousarray(query, np.float32)
        key = np.ascontiguousarray(key, np.float32)
        if len(key) < overlap_len:
            return 0
        return int(self._lib.gsv_sola_offset(
            query.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), overlap_len,
            key.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(key)))

    def viterbi_monotonic(self, probs: np.ndarray) -> np.ndarray:
        self.calls["viterbi_monotonic"] += 1
        probs = np.ascontiguousarray(probs, np.float32)
        t, n = probs.shape
        out = np.zeros(t, np.int64)
        self._lib.gsv_viterbi_monotonic(
            probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out

    def envelope_follow(self, level: np.ndarray, att: float, rel: float) -> np.ndarray:
        """Attack/release one-pole level detector (the compressor's
        ballistics)."""
        self.calls["envelope_follow"] += 1
        level = np.ascontiguousarray(level, np.float32)
        out = np.empty_like(level)
        self._lib.gsv_envelope_follow(
            level.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(level),
            ctypes.c_float(att), ctypes.c_float(rel),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def freeverb(self, x: np.ndarray, comb_delays, ap_delays, feedback: float,
                 damp: float) -> np.ndarray:
        """Freeverb wet path (8 damped combs + 4 JUCE allpass sections) as
        O(1)-a-sample delay lines."""
        self.calls["freeverb"] += 1
        x = np.ascontiguousarray(x, np.float32)
        cds = np.ascontiguousarray(comb_delays, np.int64)
        ads = np.ascontiguousarray(ap_delays, np.int64)
        out = np.empty(len(x), np.float64)
        self._lib.gsv_freeverb(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
            cds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(cds),
            ads.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(ads),
            ctypes.c_double(feedback), ctypes.c_double(damp),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out


@functools.lru_cache(maxsize=None)
def _bind(handle: ctypes.CDLL) -> _NativeLib:
    return _NativeLib(handle)


def native_lib() -> Optional[_NativeLib]:
    """The library, built on the first call (``load_host_library`` keeps the
    handle, and a failed build's error) and bound once; ``None`` while
    ``GSV_DISABLE_NATIVE`` is set or when no host compiler is found.  A
    failed build raises (with the compiler's log) on every call."""
    if os.environ.get("GSV_DISABLE_NATIVE"):
        return None
    from .cuda_build import load_host_library

    handle = load_host_library(*LIBRARY)
    return None if handle is None else _bind(handle)
