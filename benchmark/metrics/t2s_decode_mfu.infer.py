"""The whole decode step's share of the card's peak over the traced slice:
the same least time of every decode step the slice's requests took, read
from the engine's step counters (whatever kernel ran them), over the
engine's decode time."""
from harness import roofline


def read(ctx):
    rs = [r for r in ctx.slice_requests if r.get("decode_steps")]
    spent = sum(r["decode_s"] for r in rs)
    least = roofline.decode_seconds(ctx, rs)
    return 100 * least / spent if spent > 0 and least else None
