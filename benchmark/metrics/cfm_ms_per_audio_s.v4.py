"""Flow-matching time a second of audio made, over the traced slice: the
program's ``gsv.sovits.cfm`` device spans (one a chunk: its 32 Euler steps
of the DiT; the longer of the host's time and the card's between the
span's CUDA events), summed over the slice's requests, over their audio
seconds.  None where the program leaves no such span."""
from harness import spans


def read(ctx):
    groups = spans.by_request(ctx)
    if groups is None:
        return None
    cfm, audio = 0.0, 0.0
    for row, recs in zip(ctx.slice_requests, groups):
        mine = [r.seconds for r in recs if r.name == "gsv.sovits.cfm"]
        if mine and row.get("audio_s"):
            cfm += sum(mine)
            audio += row["audio_s"]
    return 1000 * cfm / audio if audio else None
