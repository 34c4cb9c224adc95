"""Mean host time of the frontend (text to phonemes) a request, over the
traced slice: ``TTS.last_timings["frontend_s"]`` after each ``infer``."""


def read(ctx):
    v = [r["frontend_s"] for r in ctx.slice_requests if "frontend_s" in r]
    return 1000 * sum(v) / len(v) if v else None
