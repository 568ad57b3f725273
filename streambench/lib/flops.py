"""Operations and bytes the logged fidelity needs, from shapes alone.

Counts follow what a row of a step needs: the visible context after the
window and the rho block keep list (denoise passes) or the whole window
(the clean pass), never what a kernel happens to read.  Peaks are NVIDIA's
data-sheet figures for one H100 SXM: 989 TFLOP/s dense bf16 and 3.35 TB/s
of HBM.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from streambench.reference.ardit import chunk_tokens, parse_key, visible_index

PEAK_BF16 = 989e12
HBM = 3.35e12


def visible_context(cfg: Dict, key: str, chunk_idx: int,
                    denoise: bool) -> int:
    """Context tokens (sink included) a row attends to in the page pool."""
    fid = parse_key(key)
    n_ctx = min(int(fid["window"]), chunk_idx, cfg["ardit_window_chunks"])
    rho = float(fid["sparsity"]) if denoise else 0.0
    return len(visible_index(cfg, n_ctx, rho))


def linear_params_per_token(cfg: Dict) -> int:
    d, hq, hkv, dh, ff = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                          cfg["d_head"], cfg["d_ff"])
    per_layer = d * hq * dh + 2 * d * hkv * dh + hq * dh * d + 2 * d * ff
    return cfg["n_layers"] * per_layer + 2 * d * cfg["latent_channels"]


def row_forward_flops(cfg: Dict, ctx: int) -> float:
    """Model operations of one row's forward over ``ctx`` visible context
    tokens: the linear layers, then scores and values over the context and
    the chunk's own keys."""
    tc = chunk_tokens(cfg)
    lin = 2.0 * linear_params_per_token(cfg) * tc
    attn = 4.0 * tc * (ctx + tc) * cfg["n_heads"] * cfg["d_head"]
    return lin + cfg["n_layers"] * attn


def paged_call(cfg: Dict, ctxs: Sequence[int]) -> Tuple[float, float]:
    """(operations, bytes) of one kernel-1 launch (one layer) over rows
    with ``ctxs`` visible context tokens each: q read once (bf16), the
    visible K and V read once in the pool's type, the page table, and the
    fp32 partials (acc, m, l) written once."""
    tc = chunk_tokens(cfg)
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    elt = 2 if cfg["kv_dtype"] == "bfloat16" else 4
    pages = 1 + cfg["ardit_window_chunks"]
    ops = sum(4.0 * tc * hq * dh * c for c in ctxs)
    nbytes = sum(2.0 * tc * hq * dh + 2.0 * c * hkv * dh * elt + 4 * pages
                 + 4.0 * hq * tc * (dh + 2) for c in ctxs)
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: operations at the bf16 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(ops / PEAK_BF16, nbytes / HBM)
