"""Shared layer substrate (dense subset): param-tree helpers, norms,
RoPE, attention projections, MLP.

Params are nested dicts of tensors; every apply fn takes the config +
params explicitly, like the JAX reference.  Stacked-layer params keep
their leading ``[L, ...]`` axis and the model code loops over it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float8_e4m3fn": torch.float8_e4m3fn}


# ---------------------------------------------------------------------------
# param trees
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_trees(trees):
    """Per-layer trees -> one tree of stacked ``[L, ...]`` tensors."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_params(p: Params, i: int) -> Params:
    """Layer ``i``'s view of the stacked ``[L, ...]`` layer params."""
    return tree_map(lambda t: t[i], p["layers"])


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in), drawn in float32 on the
    CPU from ``gen`` (values do not depend on the target device)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [B,S,H,D]; positions: [S] or [B,S] (absolute)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = positions.to(torch.float32)
    if positions.ndim == 1:
        ang = pos[None, :, None] * freqs                  # [1,S,half]
    else:
        ang = pos[:, :, None] * freqs                     # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention projections
# ---------------------------------------------------------------------------

def init_attn(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, hq * dh), dtype),
        "wk": dense_init(gen, (d, hkv * dh), dtype),
        "wv": dense_init(gen, (d, hkv * dh), dtype),
        "wo": dense_init(gen, (hq * dh, d), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * dh,), dtype=dtype)
        p["bk"] = torch.zeros((hkv * dh,), dtype=dtype)
        p["bv"] = torch.zeros((hkv * dh,), dtype=dtype)
    return p


def attn_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
             positions: torch.Tensor):
    """Project + RoPE.  Returns q [B,S,Hq,Dh], k,v [B,S,Hkv,Dh]."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {"w_gate": dense_init(gen, (d, f), dtype),
                "w_up": dense_init(gen, (d, f), dtype),
                "w_down": dense_init(gen, (f, d), dtype)}
    return {"wi": dense_init(gen, (d, f), dtype),
            "wo": dense_init(gen, (f, d), dtype)}


def mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]
