"""Per-layer arithmetic shared by the metric readers of several cells."""
from __future__ import annotations

from typing import List, Optional

from streambench.lib import flops
from streambench.lib.serve import StepRecord


def traced_steps(ctx) -> List[StepRecord]:
    """Launched steps that ran wholly inside the traced window."""
    t = ctx.trace
    return [s for s in ctx.rec.steps if s.launched
            and s.start >= t["t_start"] and s.end <= t["t_end"]]


def rows_per_step(ctx) -> Optional[float]:
    steps = ctx.window_steps()
    if not steps:
        return None
    return sum(len(s.keys) for s in steps) / len(steps)


def row_step_ms(ctx) -> Optional[float]:
    if ctx.trace is None:
        return None
    rows = sum(len(s.keys) for s in traced_steps(ctx))
    return 1e3 * ctx.trace["busy_s"] / rows if rows else None


def paged_attn_roofline(ctx) -> Optional[float]:
    if ctx.trace is None or ctx.trace["paged_s"] <= 0:
        return None
    cfg = ctx.cfg
    least = 0.0
    for s in traced_steps(ctx):
        ctxs = [flops.visible_context(cfg, k, n, dn)
                for k, n, dn in zip(s.keys, s.chunk_idx, s.denoise)]
        least += cfg["n_layers"] * flops.bound_seconds(
            *flops.paged_call(cfg, ctxs))
    return 100.0 * least / ctx.trace["paged_s"] if least else None


def mfu(ctx) -> Optional[float]:
    cfg = ctx.cfg
    total = 0.0
    for s in ctx.window_steps():
        for k, n, dn in zip(s.keys, s.chunk_idx, s.denoise):
            total += flops.row_forward_flops(
                cfg, flops.visible_context(cfg, k, n, dn))
    if not total:
        return None
    return 100.0 * total / (ctx.rec.window.seconds * flops.PEAK_BF16)
