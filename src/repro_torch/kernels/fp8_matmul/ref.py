"""Plain PyTorch version of the scaled fp8 matmul (fidelity knob Q).

SageAttention2-style online quantization: operands are dynamically
scaled per row / per column into ``float8_e4m3fn`` with no weight
reloading; the matmul accumulates in fp32 and folds the scales back at
the end.  ``fp8_matmul_ref`` is what the CUDA kernel
(``csrc/fp8_matmul.cu``) computes: the CPU tests run it, and
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.kvcache import to_fp8_e4m3

FP8_MAX = 448.0         # float8_e4m3fn dynamic range


def quantize_fp8_ref(x: torch.Tensor,
                     axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slice dynamic quantization along ``axis`` (the contracted
    dim).  Returns (x_fp8, scale) with x ~= x_fp8 * scale (scale
    broadcastable, fp32).  The cast keeps the reference's overflow rule
    (``kvcache.to_fp8_e4m3``: NaN past e4m3's range, never saturation),
    so an infinite or NaN input quantizes as it does in the reference."""
    xf = x.float()
    amax = torch.amax(xf.abs(), dim=axis, keepdim=True)
    # a tensor divisor, not the Python scalar: on a CUDA tensor torch
    # turns division by a scalar into a product with its rounded
    # reciprocal, which misses the reference's quotient by an ulp
    scale = torch.clamp_min(amax, 1e-12) / torch.full_like(amax, FP8_MAX)
    return to_fp8_e4m3(xf / scale), scale


def fp8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor) -> torch.Tensor:
    """x_q [M,K] fp8, w_q [K,N] fp8, sx [M,1], sw [1,N] -> [M,N] fp32."""
    acc = x_q.float() @ w_q.float()
    return acc * sx * sw
