"""Mean self time of the facade's ``infer`` over the traced slice: each
``gsv.request.infer`` span's host time less the part its child spans
(the frontend, the t2s generation, the SoVITS decode, the finish) cover."""
from harness import spans


def read(ctx):
    groups = spans.by_request(ctx)
    if groups is None:
        return None
    v = [spans.self_seconds(root, [r for r in recs if r.parent == root.id])
         for recs in groups for root in recs
         if root.name == "gsv.request.infer" and root.parent is None]
    return 1000 * sum(v) / len(v) if v else None
