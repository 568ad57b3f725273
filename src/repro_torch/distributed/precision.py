"""Precision levers: ``bf16_cotangent``, a port of the JAX reference's
``distributed/precision.py``.

Identity in the forward pass; in the backward pass it rounds the
cotangent to bf16 and back to its own dtype.  The forward inserts it at
layer boundaries under ``cfg.bf16_backward`` (``transformer.forward``),
forcing backward activation gradients down to bf16; the fp32 master
math of the optimizer is unaffected.
"""
from __future__ import annotations

import torch


class _BF16Cotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_cotangent(x: torch.Tensor) -> torch.Tensor:
    """x unchanged; its gradient rounded through bf16."""
    return _BF16Cotangent.apply(x)
