"""95th percentile of time to first chunk over the window's arrivals,
censored at the stop for streams not yet served: recorded above capacity,
not judged (it swings with the backlog)."""


def read(ctx):
    return ctx.summary.get("ttfc_p95_s")
