"""The traced slice: ``torch.profiler`` over a steady stretch of the window,
reduced to what the per-layer readers and the result line need.

Device time comes from the CUDA kernel events of the trace: their union is
the busy time, the slice's wall clock the window, kernel time summed by
name the roofline readers' denominators, and each gap between kernels of
more than ``GAP_S`` is charged to the innermost host operation running at
its midpoint ("what the host was doing")."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

GAP_S = 20e-6


class Slice:
    """Start and stop a profiler; ``summary()`` reduces its events."""

    def __init__(self):
        import torch

        self._torch = torch
        self.cuda = torch.cuda.is_available()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = None

    def _sync(self):
        if self.cuda:
            self._torch.cuda.synchronize()

    def start(self):
        import time

        self._sync()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        import time

        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self):
        """The reduced slice, or None when the window closed before it began."""
        if self.t1 is None:
            return None
        return reduce_events(self.prof.events(), self.t1 - self.t0)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_events(events, window_s: float) -> dict:
    """Kernel seconds by name, busy seconds, the idle gaps by host operation,
    from profiler events (times in microseconds)."""
    kernels: Dict[str, float] = defaultdict(float)
    k_iv, host = [], []
    for e in events:
        tr = e.time_range
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            kernels[e.name] += (tr.end - tr.start) * 1e-6
            k_iv.append((tr.start, tr.end))
        else:
            host.append((tr.start, tr.end, e.name))
    busy = _merge(k_iv)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps: Dict[str, float] = defaultdict(float)
    host.sort()
    starts = [h[0] for h in host]
    for (a0, a1), (b0, _) in zip(busy, busy[1:]):
        if (b0 - a1) * 1e-6 < GAP_S:
            continue
        mid = 0.5 * (a1 + b0)
        name, best = "(no host op)", None
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(-1, i - 400), -1):  # innermost op covering mid
            s, e, n = host[j]
            if s <= mid <= e and (best is None or s > best):
                name, best = n, s
        gaps[name] += (b0 - a1) * 1e-6
    if busy:  # the slice's edges: the host before the first and after the last kernel
        span_s = (busy[-1][1] - busy[0][0]) * 1e-6
        gaps["(slice edges)"] += max(0.0, window_s - span_s)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels": dict(kernels), "busy_s": busy_s, "window_s": window_s,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in idle]}}


def kernel_seconds(summary: dict, *patterns: str) -> float:
    """Device seconds of the kernels whose name contains any pattern."""
    return sum(s for n, s in summary["kernels"].items() if any(p in n for p in patterns))
