"""Latency spans and counters (counterpart of ``gsv_tts_tpu/utils/timing.py``).

``Timings.span`` feeds per-name rolling reservoirs summarized as count,
p50, p95, mean and last.  The JAX module's ``jax_profile`` and
``enable_compilation_cache`` wrap JAX's profiler and compile cache, which
have no counterpart here, and are not copied; nor are its ``RTFMeter`` and
``percentile``, which nothing in this package reads.  A span around work on
the card measures that work only if the work ends in a synchronisation
inside it (the facade's spans end in a copy to the host).

:class:`span` times one stage of the program (``gsv.<layer>.<stage>``).
With no ``torch.profiler`` collecting it reads the clock on entry and exit
and one flag, nothing more.  While a profiler collects, it also opens a
profiler range of its name, so the stage sits in the trace beside the
kernels it launched, and appends a :class:`SpanRecord` to the bounded
process log :data:`SPAN_LOG`: name, start and end on ``time.perf_counter``,
its parent and request (one request per outermost span of a thread; the
facade's public calls open ``gsv.request.<call>``), the thread, and with
``device=True`` a pair of CUDA events, read only after the trace.  Spans
add no synchronisation.  A call whose spans do not nest, a stream that
yields, takes one :func:`request_id` and passes it to the span it opens at
each resumption.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

import torch

# a profiler range of the function scope: unlike ``torch.profiler.record_function``
# it puts no range on the card's timeline, where a trace would read it as a kernel
from torch._C._profiler import _RecordFunctionFast as _Range

_profiling = torch.autograd._profiler_enabled
#: the spans recorded while a profiler collected, oldest first (bounded)
SPAN_LOG: deque = deque(maxlen=1 << 16)
REQUEST = "gsv.request."
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()


def request_id() -> int:
    """A new request id, for the spans of a call that do not nest in one."""
    return next(_requests)


class SpanRecord:
    """One traced span.  ``parent`` and ``request`` are ids; ``events`` the
    (start, end) CUDA events of a device span; ``attrs`` what the span set
    (``steps`` of a decode chunk, ``allocs`` — the allocator's
    ``num_device_alloc`` at entry and exit — of a request span)."""

    __slots__ = ("id", "name", "t0", "t1", "parent", "request", "thread", "events", "ended",
                 "attrs")

    def __init__(self, name, parent, request, events):
        self.id = next(_ids)
        self.name = name
        self.t0 = self.t1 = None
        self.parent = parent
        self.request = request
        self.thread = threading.get_ident()
        self.events = events
        self.ended = False  # the end event is recorded
        self.attrs = {}

    def device_s(self) -> Optional[float]:
        """Seconds between the span's CUDA events (None without them, or
        while the card has not reached them)."""
        if not self.events:
            return None
        try:
            return self.events[0].elapsed_time(self.events[1]) * 1e-3
        except RuntimeError:  # not reached yet
            return None

    @property
    def seconds(self) -> float:
        """Host wall time, or for a device span the longer of it and the
        card's time between its events."""
        host = self.t1 - self.t0
        dev = self.device_s()
        return host if dev is None else max(host, dev)


def _stack() -> List[SpanRecord]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _allocs() -> Optional[int]:
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_stats().get("num_device_alloc")


class span:
    """``with span("gsv.t2s.chunk", device=True) as s:`` — ``s.t0`` / ``s.t1``
    and ``s.seconds`` are its clock reads; :meth:`device_end` marks the end
    of its device work early, :meth:`set` attaches numbers to its record
    (both do nothing while no profiler collects).  An outermost span takes
    ``request`` as its request id, or a new one."""

    __slots__ = ("name", "device", "request", "t0", "t1", "rec", "_range")

    def __init__(self, name: str, device: bool = False, request: Optional[int] = None):
        self.name = name
        self.device = device
        self.request = request
        self.rec = None

    def __enter__(self) -> "span":
        if _profiling():
            self._open()
        self.t0 = time.perf_counter()
        if self.rec is not None:
            self.rec.t0 = self.t0
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        if self.rec is not None:
            self._close()
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def set(self, **attrs):
        if self.rec is not None:
            self.rec.attrs.update(attrs)

    def device_end(self):
        """Record the end event here, after the last launch of the span's
        device work, rather than at exit."""
        rec = self.rec
        if rec is not None and rec.events and not rec.ended:
            rec.events[1].record()
            rec.ended = True

    def _open(self):
        self._range = _Range(self.name)
        self._range.__enter__()
        st = _stack()
        parent = st[-1] if st else None
        events = None
        if (self.device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        if parent is not None:
            request = parent.request
        else:
            request = self.request if self.request is not None else next(_requests)
        rec = SpanRecord(self.name, parent.id if parent else None, request, events)
        if self.name.startswith(REQUEST):
            rec.attrs["allocs"] = (_allocs(), None)
        st.append(rec)
        SPAN_LOG.append(rec)
        self.rec = rec

    def _close(self):
        rec = self.rec
        rec.t1 = self.t1
        if rec.events and not rec.ended:
            rec.events[1].record()
            rec.ended = True
        if "allocs" in rec.attrs:
            rec.attrs["allocs"] = (rec.attrs["allocs"][0], _allocs())
        st = _stack()
        if st and st[-1] is rec:
            st.pop()
        elif rec in st:  # a generator's span closed out of order
            st.remove(rec)
        self._range.__exit__(None, None, None)
        self._range = None


def span_log() -> List[SpanRecord]:
    """The recorded spans, oldest first."""
    return list(SPAN_LOG)


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
