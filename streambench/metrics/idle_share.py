"""Share of the traced window with no kernel running on the card, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
