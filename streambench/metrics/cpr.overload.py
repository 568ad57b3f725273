"""CPR above capacity: recorded, not judged (it swings with the backlog)."""


def read(ctx):
    return ctx.summary.get("cpr")
