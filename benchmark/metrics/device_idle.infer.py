"""Share of the traced slice's wall time in which no kernel ran on the card."""


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0 or ctx.trace["window_s"] <= 0:
        return None
    return 100 * (1 - ctx.trace["busy_s"] / ctx.trace["window_s"])
