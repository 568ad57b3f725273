"""Plain PyTorch version of the flash-attention kernel and its backward.

As in the JAX reference, the model-side attention substrate *is* the
reference implementation: ``flash_mha_ref`` is ``models.attention``'s
plain ``mha`` body (fp32 online softmax over the direct path and the
static block schedules), under the kernel-oracle name and signature;
with ``return_lse`` it also returns the log-sum-exp the kernel writes
for its backward.  ``flash_mha_seeded_ref`` is the plain version of the
seeded form: ``paged_mha``'s in-chunk segment as it runs off the card
(the fp32 segment over the chunk's own keys, merged with the paged
context's partials, divided and laid out).  ``flash_mha_bwd_ref`` is the
plain version of the backward kernels: FlashAttention-2's recompute
formulas over a dense visibility mask, fp32 (float64 for float64
inputs), as the CUDA-core kernel (``csrc/flash_mha_bwd.cu``) computes
them, or with ``round_bf16`` rounding P and dS to bf16 before the
products that take them, as the tensor-core kernel
(``csrc/flash_mha_bwd_wgmma.cu``) does.  The CPU tests run both, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.attention import (_finalize, _group, _merge,
                                          _segment_attn, mha_plain)


def flash_mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  n_kv_heads: int, causal: bool = True, q_offset: int = 0,
                  window: int = 0, sink: int = 0, sparsity: float = 0.0,
                  block_q: int = 512, block_kv: int = 512,
                  return_lse: bool = False):
    """q [B,Sq,Hq,D]; k,v [B,Skv,Hkv,D] -> [B,Sq,Hq,D], or with
    ``return_lse`` (out, lse [B,Hq,Sq] fp32; -inf for rows that see
    nothing)."""
    return mha_plain(q, k, v, n_kv_heads=n_kv_heads, causal=causal,
                     q_offset=q_offset, window=window, sink=sink,
                     sparsity=sparsity, block_q=block_q, block_kv=block_kv,
                     return_lse=return_lse)


def flash_mha_seeded_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                         *, n_kv_heads: int) -> torch.Tensor:
    """q [B,Sq,Hq,D] over k,v [B,Skv,Hkv,D], every key visible, each row's
    online softmax continued from its partial m, l [B,Hkv,G,Sq] and acc
    [B,Hkv,G,Sq,D] (``paged_chunk_attention``'s) -> [B,Sq,Hq,D] in q's
    dtype: the fp32 segment (float64 for float64 inputs), the merge, the
    divide (0 where l is 0), the layout."""
    b, sq, hq, d = q.shape
    own = _segment_attn(_group(q, n_kv_heads), k, v, None, 1.0 / math.sqrt(d))
    out = _finalize(_merge((m, l, acc), own), q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


def visibility(sq: int, skv: int, *, causal: bool, q_offset: int,
               window: int, sink: int, sparsity: float, block_q: int,
               block_kv: int, device=None) -> Optional[torch.Tensor]:
    """[Sq, Skv] bool: whether query i sees key j in the kernel's mode
    (the predicate of ``flash_mha.cu``), or None when every key is
    visible (non-causal).  rho applies at the caller's block granularity
    through ``ops.keep_matrix``, which ``flash_mha`` accepts only on the
    causal schedule without a window."""
    if not causal:
        return None
    qp = q_offset + torch.arange(sq, device=device)
    kp = torch.arange(skv, device=device)
    vis = qp[:, None] >= kp[None, :]
    if window:
        vis &= (kp[None, :] > qp[:, None] - window) | (kp[None, :] < sink)
    if sparsity > 0.0:
        from repro_torch.kernels.flash_attention.ops import keep_matrix
        keep = torch.as_tensor(keep_matrix(
            sq // block_q, skv // block_kv, causal=causal,
            q_offset=q_offset, window=window, sink=sink, sparsity=sparsity,
            block_q=block_q, block_kv=block_kv), device=device).bool()
        vis &= keep.repeat_interleave(block_q, 0).repeat_interleave(
            block_kv, 1)
    return vis


def flash_mha_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, n_kv_heads: int,
                      causal: bool = True, q_offset: int = 0,
                      window: int = 0, sink: int = 0, sparsity: float = 0.0,
                      block_q: int = 512, block_kv: int = 512,
                      round_bf16: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_mha_ref`` at (q, k, v) for the
    output cotangent ``dout``, given the forward's output ``o`` and
    ``lse`` [B,Hq,Sq]:

        delta = rowsum(dout * o);  P = exp(s * scale - lse) where visible
        dV = P^T dout;  dS = P * (dout V^T - delta)
        dQ = dS K * scale;  dK = dS^T Q * scale

    one KV head at a time (its G query heads summed into dK, dV), so the
    [B, G, Sq, Skv] scores of one head are the largest temporary.  Rows
    with lse = -inf contribute nothing.  With ``round_bf16`` P is rounded
    to bf16 before dV's product and dS before dQ's and dK's (the
    tensor-core kernel's arithmetic); every sum stays in the wide type.
    Outputs in the inputs' dtypes."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    g = hq // n_kv_heads
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(d)
    vis = visibility(sq, skv, causal=causal, q_offset=q_offset,
                     window=window, sink=sink, sparsity=sparsity,
                     block_q=block_q, block_kv=block_kv, device=q.device)
    qf = q.to(wide).reshape(b, sq, n_kv_heads, g, d)
    dof = dout.to(wide).reshape(b, sq, n_kv_heads, g, d)
    kf, vf = k.to(wide), v.to(wide)
    delta = (dof * o.to(wide).reshape(b, sq, n_kv_heads, g, d)).sum(-1)
    lse_g = lse.to(wide).reshape(b, n_kv_heads, g, sq)
    dq = torch.empty_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for h in range(n_kv_heads):
        s = torch.einsum("bqgd,bkd->bgqk", qf[:, :, h], kf[:, :, h]) * scale
        lh = lse_g[:, h, :, :, None]                           # [B,G,Sq,1]
        live = torch.isfinite(lh) if vis is None \
            else vis & torch.isfinite(lh)
        p = torch.where(live, torch.exp(s - torch.where(
            torch.isfinite(lh), lh, 0.0)), 0.0)
        dp = torch.einsum("bqgd,bkd->bgqk", dof[:, :, h], vf[:, :, h])
        ds = p * (dp - delta[:, :, h].permute(0, 2, 1)[..., None])
        if round_bf16:
            p, ds = (t.to(torch.bfloat16).to(wide) for t in (p, ds))
        dv[:, :, h] = torch.einsum("bgqk,bqgd->bkd", p, dof[:, :, h])
        dq[:, :, h] = torch.einsum("bgqk,bkd->bqgd", ds, kf[:, :, h]) * scale
        dk[:, :, h] = torch.einsum("bgqk,bqgd->bkd", ds, qf[:, :, h]) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
