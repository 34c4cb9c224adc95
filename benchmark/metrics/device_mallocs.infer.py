"""Device allocations a request over the traced slice: the change of the
caching allocator's ``num_device_alloc`` (a ``cudaMalloc`` each) across
each of the program's request spans, which read it at entry and exit while
traced, summed over the slice and divided by its requests.  None on the
CPU."""
from harness import spans


def read(ctx):
    groups = spans.by_request(ctx)
    if not groups:
        return None
    deltas = [r.attrs["allocs"] for recs in groups for r in recs
              if r.parent is None and "allocs" in r.attrs]
    if not deltas or any(a is None or b is None for a, b in deltas):
        return None
    return sum(b - a for a, b in deltas) / len(groups)
