"""SoVITS time outside CUDA-graph replays a request, over the traced slice:
the program's ``gsv.sovits.capture`` (a graph captured in the window) and
``gsv.sovits.eager`` (the exact core, a frame-wise ``ge``, a program run
on the CPU) spans, summed a request."""
from harness import spans

NAMES = ("gsv.sovits.capture", "gsv.sovits.eager")


def read(ctx):
    groups = spans.by_request(ctx)
    if not groups:
        return None
    total = sum(r.seconds for recs in groups for r in recs if r.name in NAMES)
    return 1000 * total / len(groups)
