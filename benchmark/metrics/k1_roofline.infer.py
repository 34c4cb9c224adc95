"""K1's share of its roofline over the traced slice: the least time of
every B=1 decode step the slice's requests took (``harness/roofline.py``:
weights once a step, the cache rows to each step's length read and the new
row written, at 3.35 TB/s or 989 TFLOP/s) over the device time of K1's two
kernels (the persistent step and its sampling launch) in the trace."""
from harness import roofline
from harness.trace import kernel_seconds


def read(ctx):
    if ctx.trace is None:
        return None
    dev = kernel_seconds(ctx.trace, "decode_step_persistent<1,", "k1_sample")
    least = roofline.decode_seconds(ctx, ctx.slice_requests)
    return 100 * least / dev if dev > 0 and least else None
