"""Mean of the frozen quality surface (the cell's model) over every chunk
ready in the window."""
from streambench.lib.quality import chunk_quality


def read(ctx):
    keys = ctx.play.keys_in_window
    if not keys:
        return None
    model = ctx.cfg["quality_model"]
    return sum(chunk_quality(k, model) for k in keys) / len(keys)
