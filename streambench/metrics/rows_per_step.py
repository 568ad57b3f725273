"""Rows a batched launch carries, over the window's launches."""
from streambench.lib.layer_metrics import rows_per_step


def read(ctx):
    return rows_per_step(ctx)
