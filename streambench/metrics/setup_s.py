"""Process start to the ramp's first arrival: imports, kernel libraries,
weights, the pool, the session's calibration chunk and the warm-up."""


def read(ctx):
    return ctx.rec.setup_s
