"""Mean t2s prefill time a request over the traced slice
(``T2SEngine.last_stats["prefill_s"]``)."""


def read(ctx):
    v = [r["prefill_s"] for r in ctx.slice_requests if "prefill_s" in r]
    return 1000 * sum(v) / len(v) if v else None
