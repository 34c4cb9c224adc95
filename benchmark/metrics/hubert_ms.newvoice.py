"""Mean HuBERT branch time of a new voice over the traced slice: the
program's ``gsv.voice.load`` and ``gsv.voice.hubert`` spans inside each
``cache_prompt_audio`` call (the prompt clip read and resampled, the
feature extractor, the twelve layers, the RVQ codes and their readback)."""
from harness import spans

NAMES = ("gsv.voice.load", "gsv.voice.hubert")


def read(ctx):
    groups = spans.by_request(ctx)
    if groups is None:
        return None
    v = [sum(r.seconds for r in spans.descendants(recs, call) if r.name in NAMES)
         for recs in groups for call in recs if call.name == "gsv.request.cache_prompt_audio"]
    return 1000 * sum(v) / len(v) if v else None
