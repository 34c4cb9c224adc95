"""The program's own spans over the traced slice.

``gsv_tts_tpu_torch.utils.timing`` keeps a record of every span opened
while a profiler collects: its name, start and end on ``time.perf_counter``
(the harness's clock), its parent, its request (one per outermost span:
the facade's public calls open ``gsv.request.<call>``), the CUDA events of
a device span and what the span set (``steps``, ``allocs``).  The readers
group the records by the slice's requests, each request taking the spans
whose root began between its call and its completion.  Against a program
that keeps no such records every function here returns None."""
from __future__ import annotations

from typing import Dict, List, Optional


def records() -> Optional[list]:
    """The program's finished span records, or None without a span log."""
    try:
        from gsv_tts_tpu_torch.utils import timing
    except ImportError:
        return None
    log = getattr(timing, "span_log", None)
    return None if log is None else [r for r in log() if r.t1 is not None]


def by_request(ctx) -> Optional[List[list]]:
    """Per request of the traced slice, the records of the program calls it made."""
    recs = records()
    if recs is None:
        return None
    t_open = ctx.win["t_open"]
    roots = [r for r in recs if r.parent is None]
    out = []
    for row in ctx.slice_requests:
        lo, hi = t_open + row["t_call"], t_open + row["t_done"]
        mine = {r.request for r in roots if lo <= r.t0 <= hi}
        out.append([r for r in recs if r.request in mine])
    return out


def descendants(recs: list, top) -> list:
    """The records below ``top`` among ``recs`` (one request's)."""
    kids: Dict[int, list] = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    out, todo = [], [top.id]
    while todo:
        for r in kids.get(todo.pop(), []):
            out.append(r)
            todo.append(r.id)
    return out


def between(a, b) -> Optional[float]:
    """Card seconds from the end event of device span ``a`` to the start
    event of ``b``, or None where either has no events."""
    if not (a.events and b.events):
        return None
    try:
        return a.events[1].elapsed_time(b.events[0]) * 1e-3
    except RuntimeError:  # an event never recorded or not reached
        return None


def self_seconds(rec, children: list) -> float:
    """``rec``'s host time less the part its children's intervals cover."""
    cover, end = 0.0, rec.t0
    for c in sorted(children, key=lambda c: c.t0):
        a, b = max(c.t0, end), min(c.t1, rec.t1)
        if b > a:
            cover += b - a
            end = b
    return (rec.t1 - rec.t0) - cover
