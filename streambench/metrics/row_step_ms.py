"""Device-busy ms per row-step: the traced window's busy time over the rows
its launches carried."""
from streambench.lib.layer_metrics import row_step_ms


def read(ctx):
    return row_step_ms(ctx)
