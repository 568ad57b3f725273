"""AdamW + LR schedules (cosine, and the WSD schedule minicpm-2b was
trained with — arXiv:2404.06395), a port of the JAX reference's
``train/optimizer.py``.

Plain tensor ops under ``torch.no_grad()`` in the reference's arithmetic
order (not ``torch.optim.AdamW``, whose order and bias correction
differ): moments in fp32, the update in fp32, the new parameter cast to
the parameter's dtype.  Parameter trees are nested dicts, walked in
sorted-key order as ``jax.tree_util`` walks them (the order of the
global norm's sum).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Sequence, Tuple

import torch

from repro_torch.models.layers import tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"          # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1           # WSD: final fraction spent decaying


class OptState(NamedTuple):
    step: torch.Tensor                # int32 scalar
    m: Any
    v: Any


def leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(key path, tensor) of every leaf of a nested dict, sorted keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), fp32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    if cfg.schedule == "wsd":
        # warmup -> stable -> decay (1-sqrt decay over the final fraction)
        decay_start = cfg.total_steps * (1.0 - cfg.decay_frac)
        frac = torch.clamp((s - decay_start)
                           / max(cfg.total_steps - decay_start, 1.0),
                           0.0, 1.0)
        return cfg.lr * warm * (1.0 - (1.0 - 0.1) * torch.sqrt(frac))
    # cosine to 10% of peak
    t = torch.clamp(s / cfg.total_steps, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params: Any) -> OptState:
    """Step 0 and fp32 zero moments on the parameters' device (laid out
    as the parameters: DTensor parameters get DTensor moments)."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    dev = next(leaves_with_path(params))[1].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                    tree_map(torch.clone, zeros))


def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for _, x in leaves_with_path(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def _decay_mask(path: Sequence[str]) -> bool:
    """Weight decay on matrices only (no norms / biases / scalars), by
    the leaf's key."""
    return str(path[-1]) not in (
        "attn_norm", "mlp_norm", "final_norm", "norm", "norm_w",
        "mixer_norm", "ffn_norm", "cross_norm", "enc_final_norm", "bq",
        "bk", "bv", "conv_b", "dt_bias", "A_log", "D", "mod_b")


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: Any, grads: Any, state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping.  Updates the parameters
    and both moments IN PLACE and returns them (the reference returns new
    trees; at full width a second copy of the state would not fit beside
    the first).  Returns (params, state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.betas
    s = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, s)
    bc2 = 1.0 - torch.pow(b2, s)
    g_of = dict(leaves_with_path(grads))
    m_of = dict(leaves_with_path(state.m))
    v_of = dict(leaves_with_path(state.v))
    for path, p in leaves_with_path(params):
        g, m, v = g_of[path], m_of[path], v_of[path]
        g32 = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if _decay_mask(path):
            u = u + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * u)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.m, state.v), metrics
