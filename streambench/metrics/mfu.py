"""The whole step's share of the chip's bf16 peak: model operations of
every row-forward completed in the window over its seconds, in %."""
from streambench.lib.layer_metrics import mfu


def read(ctx):
    return mfu(ctx)
