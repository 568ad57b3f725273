"""Kernel 1's share of its roofline: the least time its launches in the
window could take (operations at the bf16 peak or bytes at the HBM peak,
per launch) over their traced device time, in %."""
from streambench.lib.layer_metrics import paged_attn_roofline


def read(ctx):
    return paged_attn_roofline(ctx)
