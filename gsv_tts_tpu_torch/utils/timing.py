"""Latency spans and counters (counterpart of ``gsv_tts_tpu/utils/timing.py``).

``Timings.span`` feeds per-name rolling reservoirs summarized as count,
p50, p95, mean and last; ``RTFMeter`` tracks the real-time factor;
``percentile`` is the nearest-rank percentile the load tools share.  The JAX
module's ``jax_profile`` and ``enable_compilation_cache`` wrap JAX's profiler
and compile cache, which have no counterpart here, and are not copied.  A
span around work on the card measures that work only if the work ends in a
synchronisation inside it (the facade's spans end in a copy to the host).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Dict


class Timings:
    """Per-name rolling latency reservoirs."""

    def __init__(self, window: int = 256):
        self._window = window
        self._data: Dict[str, deque] = defaultdict(lambda: deque(maxlen=window))

    def record(self, name: str, seconds: float):
        self._data[name].append(seconds)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self._data.items():
            if not vals:
                continue
            s = sorted(vals)
            n = len(s)
            out[name] = {
                "count": n,
                "p50": s[n // 2],
                "p95": s[min(n - 1, int(n * 0.95))],
                "mean": sum(s) / n,
                "last": vals[-1],
            }
        return out


# process-wide default instance
timings = Timings()


class RTFMeter:
    """Real-time-factor meter: synthesized seconds against wall seconds."""

    def __init__(self):
        self.wall = 0.0
        self.audio = 0.0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.wall += time.perf_counter() - t0

    def add_audio(self, seconds: float):
        self.audio += seconds

    @property
    def rtf(self) -> float:
        return self.wall / self.audio if self.audio else float("inf")


def percentile(xs, q: float):
    """Nearest-rank percentile over the non-None values (None when empty)."""
    xs = sorted(x for x in xs if x is not None)
    if not xs:
        return None
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]
