"""Share of the traced slice's GPT-SoVITS v4 ``decode_encp`` calls that
replayed a CUDA graph: the program's ``gsv.sovits.encp.replay`` spans over
all ``gsv.sovits.encp.*`` children of ``gsv.sovits.encp`` (two a request:
the prompt's call and the output's).  None without a span log, or where the
program marks neither a replay nor an eager call (``gsv.sovits.encp.eager``)
below them."""
from harness import spans

TOP = "gsv.sovits.encp"
REPLAY, EAGER = TOP + ".replay", TOP + ".eager"


def read(ctx):
    groups = spans.by_request(ctx)
    if groups is None:
        return None
    recs = [r for g in groups for r in g]
    tops = {r.id for r in recs if r.name == TOP}
    calls = [r.name for r in recs if r.parent in tops and r.name in (REPLAY, EAGER)]
    if not calls:
        return None
    return calls.count(REPLAY) / len(calls)
