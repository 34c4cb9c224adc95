"""Share of the traced slice's ERes2NetV2 embeddings that replayed a CUDA
graph: the program's ``gsv.voice.sv_emb`` spans with a
``gsv.voice.sv_emb.replay`` child, over all of them.  None without a span
log, without such spans, or where the program marks neither a replay nor
an eager run (``gsv.voice.sv_emb.eager``) below them."""
from harness import spans

TOP = "gsv.voice.sv_emb"
REPLAY, EAGER = TOP + ".replay", TOP + ".eager"


def read(ctx):
    groups = spans.by_request(ctx)
    if groups is None:
        return None
    recs = [r for g in groups for r in g]
    tops = {r.id for r in recs if r.name == TOP}
    kids = {(r.parent, r.name) for r in recs if r.parent in tops}
    if not tops or not any(name in (REPLAY, EAGER) for _, name in kids):
        return None
    return sum((t, REPLAY) in kids for t in tops) / len(tops)
