"""Plain PyTorch version of the flash-attention kernel.

As in the JAX reference, the model-side attention substrate *is* the
reference implementation: ``flash_mha_ref`` is ``models.attention``'s
plain ``mha`` body (fp32 online softmax over the direct path and the
static block schedules), under the kernel-oracle name and signature.
The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel
(``csrc/flash_mha.cu``) against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import mha_plain


def flash_mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  n_kv_heads: int, causal: bool = True, q_offset: int = 0,
                  window: int = 0, sink: int = 0, sparsity: float = 0.0,
                  block_q: int = 512, block_kv: int = 512) -> torch.Tensor:
    """q [B,Sq,Hq,D]; k,v [B,Skv,Hkv,D] -> [B,Sq,Hq,D]."""
    return mha_plain(q, k, v, n_kv_heads=n_kv_heads, causal=causal,
                     q_offset=q_offset, window=window, sink=sink,
                     sparsity=sparsity, block_q=block_q, block_kv=block_kv)
