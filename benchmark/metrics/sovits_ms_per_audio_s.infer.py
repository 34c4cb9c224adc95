"""SoVITS time (flow, vocoder, their CUDA graphs) a second of audio made,
over the traced slice: summed ``last_timings["sovits_s"]`` over the audio."""


def read(ctx):
    rs = [r for r in ctx.slice_requests if "sovits_s" in r and r.get("audio_s")]
    audio = sum(r["audio_s"] for r in rs)
    return 1000 * sum(r["sovits_s"] for r in rs) / audio if audio else None
