"""The flow-matching decoder's share of the card's bf16 peak over the
traced slice: the DiT work of every chunk the slice's requests ran
(``families/cfm.py:dit_flops`` of the chunk's frames and Euler steps, which
the program's ``gsv.sovits.cfm`` span records; no padding counted) over the
seconds of those spans at 989 TFLOP/s (H100 SXM, dense bf16).  None where
the program leaves no such span."""
from harness import spans
from harness.cli import load_family

PEAK_FLOPS = 989e12


def read(ctx):
    groups = spans.by_request(ctx)
    if groups is None:
        return None
    fam = load_family(ctx.cfg)
    widths = ctx.cfg["sovits"]["model"].get("cfm")
    flops, seconds = 0, 0.0
    for recs in groups:
        for r in recs:
            if r.name == "gsv.sovits.cfm" and "frames" in r.attrs:
                flops += fam.dit_flops(r.attrs["frames"], r.attrs["steps"], widths)
                seconds += r.seconds
    return 100 * flops / (seconds * PEAK_FLOPS) if seconds > 0 else None
