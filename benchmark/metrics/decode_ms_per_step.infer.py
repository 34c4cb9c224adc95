"""t2s decode time a step over the traced slice: the engine's summed
``decode_s`` over its summed ``decode_steps``."""


def read(ctx):
    rs = [r for r in ctx.slice_requests if r.get("decode_steps")]
    steps = sum(r["decode_steps"] for r in rs)
    return 1000 * sum(r["decode_s"] for r in rs) / steps if steps else None
