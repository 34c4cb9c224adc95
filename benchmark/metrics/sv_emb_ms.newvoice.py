"""Mean ERes2NetV2 speaker-embedding time of a new voice over the traced
slice: the program's ``gsv.voice.sv_emb`` device span (the fbank on the
host, the blocks on the card), the longer of its host time and the card's
time between its CUDA events."""
from harness import spans


def read(ctx):
    groups = spans.by_request(ctx)
    if groups is None:
        return None
    v = [r.seconds for recs in groups for r in recs if r.name == "gsv.voice.sv_emb"]
    return 1000 * sum(v) / len(v) if v else None
