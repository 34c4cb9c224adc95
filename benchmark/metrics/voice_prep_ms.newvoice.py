"""Mean time a new voice takes to prepare, over the traced slice: the
benchmark's span around ``cache_spk_audio`` and ``cache_prompt_audio``
(HuBERT, the spectrogram and style encoder, ERes2NetV2)."""


def read(ctx):
    v = [r["voice_prep_s"] for r in ctx.slice_requests if "voice_prep_s" in r]
    return 1000 * sum(v) / len(v) if v else None
