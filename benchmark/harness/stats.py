"""Tails and spreads, as the benchmark reports them."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in 0..100) of every value given: the
    smallest value with at least q % of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[k - 1])


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("inf")


def lead_and_underrun(chunks) -> tuple:
    """Realtime accounting of one stream (``tools/load_test.py``'s lead,
    rewritten for in-process chunks): ``chunks`` are (arrival s, audio s)
    in order.  Playback starts at the first chunk; a chunk is late when it
    arrives after the audio before it has played out.  Returns (the least
    lead in s over the stream, whether it never underran)."""
    if not chunks:
        return 0.0, False
    start = chunks[0][0]
    played, lead = 0.0, math.inf
    for arrive, audio in chunks:
        lead = min(lead, start + played - arrive)
        played += audio
    return (0.0 if lead is math.inf else lead), lead >= -1e-9
