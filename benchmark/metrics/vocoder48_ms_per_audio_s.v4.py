"""48 kHz vocoder time a second of audio made, over the traced slice: the
program's ``gsv.sovits.vocoder`` device spans (the bucket's CUDA graph
replay and the audio's readback), summed over the slice's requests, over
their audio seconds.  None where the program leaves no such span."""
from harness import spans


def read(ctx):
    groups = spans.by_request(ctx)
    if groups is None:
        return None
    voc, audio = 0.0, 0.0
    for row, recs in zip(ctx.slice_requests, groups):
        mine = [r.seconds for r in recs if r.name == "gsv.sovits.vocoder"]
        if mine and row.get("audio_s"):
            voc += sum(mine)
            audio += row["audio_s"]
    return 1000 * voc / audio if audio else None
