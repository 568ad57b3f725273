"""Attention substrate with the paper's fidelity knobs (the serving
subset of the JAX reference's ``models/attention.py``).

* ``mha`` — the direct path: one dense masked segment, with an optional
  per-row ``kv_mask`` (the batched executor's visibility masks).
* ``paged_mha`` — page-table-native chunk attention: online-softmax
  partials over the paged KV pool (the ``kernels/paged_attention``
  CUDA kernel on the card, its plain PyTorch version on the CPU) merged
  with the chunk's own fresh KV before the softmax divide.

Numerics: fp32 online-softmax accumulation regardless of input dtype.
Two masking conventions coexist, as in the reference: the dense path
masks with ``-inf`` and guards fully-masked rows with ``m_safe``; the
paged partials mark rows that see nothing with ``m == NEG_INF = -1e30``
(``_merge`` relies on it).  The blocked causal / window / sparse paths
of the reference's ``mha`` wait for their slice (ROADMAP).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,Hq,D] -> [B,S,Hkv,G,D] without materializing repeated KV."""
    b, s, hq, d = q.shape
    assert hq % n_kv == 0, (hq, n_kv)
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _segment_attn(q, k, v, mask, scale):
    """One (q-block, kv-segment) flash step.

    q: [B,bq,Hkv,G,D]; k/v: [B,skv,Hkv,D]; mask: [bq,skv] or
    [B,bq,skv] bool, or None.  Returns unnormalized partials
    (s_max, p_sum, p_v) in fp32.
    """
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if mask is not None:
        mask = mask[None, None, None] if mask.ndim == 2 \
            else mask[:, None, None]
        s = torch.where(mask, s, -math.inf)
    m = torch.amax(s, dim=-1)                                 # [B,H,G,bq]
    # guard fully-masked rows (all -inf)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = torch.sum(p, dim=-1)                                  # [B,H,G,bq]
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return m_safe, l, pv


def _merge(acc, new):
    """Merge two online-softmax partials."""
    m0, l0, o0 = acc
    m1, l1, o1 = new
    m = torch.maximum(m0, m1)
    c0 = torch.exp(m0 - m)
    c1 = torch.exp(m1 - m)
    return m, l0 * c0 + l1 * c1, o0 * c0[..., None] + o1 * c1[..., None]


def _finalize(acc, dtype):
    _, l, o = acc
    l = torch.where(l == 0.0, 1.0, l)               # fully-masked rows -> 0
    return (o / l[..., None]).to(dtype)             # [B,H,G,bq,D]


def _init_acc(b, h, g, bq, d, device=None):
    z = torch.zeros((b, h, g, bq), dtype=torch.float32, device=device)
    return (torch.full((b, h, g, bq), -math.inf, dtype=torch.float32,
                       device=device), z,
            torch.zeros((b, h, g, bq, d), dtype=torch.float32,
                        device=device))


def sparse_keep_list(n_q_blocks: int, n_kv_blocks_per_q: Sequence[int],
                     sparsity: float, sink_blocks: int = 1) -> List[List[int]]:
    """Deterministic strided block keep-list for the rho fidelity knob.

    For q block i with causal KV blocks [0..i], always keep the sink block(s)
    and the diagonal block; keep a strided ~(1-rho) fraction of the rest.
    """
    keep: List[List[int]] = []
    frac = max(1e-6, 1.0 - sparsity)
    for i in range(n_q_blocks):
        n_kv = n_kv_blocks_per_q[i]
        forced = set(range(min(sink_blocks, n_kv))) | {n_kv - 1}
        middle = [j for j in range(n_kv) if j not in forced]
        n_keep = int(round(len(middle) * frac))
        if n_keep >= len(middle):
            chosen = middle
        elif n_keep <= 0:
            chosen = []
        else:
            idx = np.linspace(0, len(middle) - 1, n_keep).round().astype(int)
            chosen = [middle[j] for j in sorted(set(idx.tolist()))]
        keep.append(sorted(forced | set(chosen)))
    return keep


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        n_kv_heads: int,
        causal: bool = True,
        q_offset: int = 0,
        window: int = 0,
        sink: int = 0,
        kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention with GQA, direct path only.

    q: [B,Sq,Hq,D]; k,v: [B,Skv,Hkv,D].  Returns [B,Sq,Hq,D].
    ``kv_mask``: optional [B,Skv] per-row KV validity — one launch
    serves rows with different fidelity windows/sparsities.  The
    reference's blocked schedules (long causal sequences, rho block
    sparsity) wait for the flash-attention slice.
    """
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qg = _group(q, n_kv_heads)
    mask = None
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        k_pos = torch.arange(skv, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= (k_pos[None, :] > q_pos[:, None] - window) | \
                    (k_pos[None, :] < sink)
    if kv_mask is not None:
        km = kv_mask[:, None, :]                         # [B,1,Skv]
        mask = km if mask is None else mask[None] & km
    out = _finalize(_segment_attn(qg, k, v, mask, scale), q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


def shard_heads(x: torch.Tensor, n_kv_heads: int, lo: int,
                hi: int) -> torch.Tensor:
    """Slice a [B,S,H,D] tensor to the heads grouped under KV heads
    [lo, hi) — the Ulysses-style head partition of elastic SP (SS4.3).
    Head order is preserved, so ``merge_head_shards`` over a covering
    partition is exact."""
    b, s, h, d = x.shape
    g = h // n_kv_heads
    return x.reshape(b, s, n_kv_heads, g, d)[:, :, lo:hi] \
        .reshape(b, s, (hi - lo) * g, d)


def merge_head_shards(outs: Sequence[torch.Tensor],
                      n_kv_heads_per_shard: Sequence[int]) -> torch.Tensor:
    """Concatenate per-shard attention outputs back into full-head
    order (inverse of ``shard_heads`` over a covering partition)."""
    b, s = outs[0].shape[:2]
    d = outs[0].shape[-1]
    parts = [o.reshape(b, s, h, -1, d)
             for o, h in zip(outs, n_kv_heads_per_shard)]
    return torch.cat(parts, dim=2).reshape(b, s, -1, d)


def paged_mha(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              block_table: torch.Tensor, page_mask: Optional[torch.Tensor],
              chunk_k: torch.Tensor, chunk_v: torch.Tensor, *,
              n_kv_heads: int, sink: int = 0,
              chunk_tokens: int = 0) -> torch.Tensor:
    """Page-table-native attention for chunk-wise generation.

    q [B,Sq,Hq,D] attends to (a) the visible cached context, read IN
    PLACE from the page pool ``k_pages``/``v_pages`` [n_pages, page,
    Hkv, D] through per-stream ``block_table`` [B, n] with
    ``page_mask`` [B, n*page] marking visible context tokens in table
    order (or None: every valid-prefix token visible), and (b) the
    chunk's own fresh KV ``chunk_k``/``chunk_v`` [B,Sq,Hkv,D]
    (bidirectional, fully visible).

    The paged segment's partials come from ``paged_chunk_attention``
    (the CUDA kernel for CUDA tensors, the plain version for CPU ones);
    the in-chunk segment is plain PyTorch, as in the reference, and the
    two merge before the softmax divide.  No contiguous context is
    materialized.  ``sink``/``chunk_tokens`` give the valid prefixes of
    the sink/ring pages so neither form computes dead page tails.
    """
    # late import: keeps ``models`` importable without the kernel package
    from repro_torch.kernels.paged_attention.ops import paged_chunk_attention
    b, sq, hq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    ctx = paged_chunk_attention(q, k_pages, v_pages, block_table,
                                page_mask, sink=sink,
                                chunk_tokens=chunk_tokens)
    own = _segment_attn(_group(q, n_kv_heads), chunk_k, chunk_v, None,
                        scale)
    out = _finalize(_merge(ctx, own), q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
