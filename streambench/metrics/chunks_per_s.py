"""Chunks made ready in the window over its seconds."""


def read(ctx):
    return ctx.summary["chunks_per_s"]
