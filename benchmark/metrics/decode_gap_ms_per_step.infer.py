"""The card's time between K1 runs a decode step, over the traced slice:
for each generation, the CUDA-event intervals from the end of the
prefill's launches to the start of the first decode chunk and from each
``gsv.t2s.chunk``'s last step to the next one's first (the host's
readbacks, kernel check, EOS scan and noise draw in between), summed over
the slice and divided by the chunks' decode steps.  None without events
(the CPU)."""
from collections import defaultdict

from harness import spans

RUN = ("gsv.t2s.prefill", "gsv.t2s.chunk")


def read(ctx):
    groups = spans.by_request(ctx)
    if groups is None:
        return None
    gap, steps = 0.0, 0
    for recs in groups:
        runs = defaultdict(list)  # a generation's prefill and chunks share a parent
        for r in recs:
            if r.name in RUN:
                runs[r.parent].append(r)
        for seq in runs.values():
            seq.sort(key=lambda r: r.t0)
            for a, b in zip(seq, seq[1:]):
                s = spans.between(a, b)
                if s is None:
                    return None
                gap += s
            steps += sum(r.attrs.get("steps", 0) for r in seq)
    return 1000 * gap / steps if steps else None
