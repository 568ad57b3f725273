"""Attention substrate with the paper's fidelity knobs (the serving
subset of the JAX reference's ``models/attention.py``).

* ``mha`` — multi-head attention with GQA and the reference's static
  block schedules: the direct path (one dense masked segment, with an
  optional per-row ``kv_mask``), the causal block-triangular schedule,
  sink + sliding window (knob W) and the rho block keep list.  On a
  CUDA tensor without ``kv_mask`` it runs the ``kernels/flash_attention``
  CUDA kernel in exactly the mode it computes; the plain body
  (``mha_plain``) is that kernel's plain version.
* ``paged_mha`` — page-table-native chunk attention: online-softmax
  partials over the paged KV pool (the ``kernels/paged_attention``
  CUDA kernel on the card, its plain PyTorch version on the CPU)
  continued over the chunk's own fresh KV before the softmax divide (in
  bf16 on the card the ``kernels/flash_attention`` kernel's seeded form,
  elsewhere plain PyTorch).
* ``decode_attention`` — single-token decode over a dense KV cache with
  per-stream valid lengths (and optional sink + window), plain PyTorch:
  the oracle inside ``kernels/paged_attention``'s decode plain version.

Numerics: fp32 online-softmax accumulation regardless of input dtype.
Two masking conventions coexist, as in the reference: the dense path
masks with ``-inf`` and guards fully-masked rows with ``m_safe``; the
paged partials mark rows that see nothing with ``m == NEG_INF = -1e30``
(``_merge`` relies on it).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.logical import (as_dtensor, batch_split,
                                             local_box, per_shard)


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,Hq,D] -> [B,S,Hkv,G,D] without materializing repeated KV."""
    b, s, hq, d = q.shape
    assert hq % n_kv == 0, (hq, n_kv)
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """fp32, or float64 for a float64 input (the CPU gradient checks)."""
    return x if x.dtype == torch.float64 else x.float()


def _segment_attn(q, k, v, mask, scale):
    """One (q-block, kv-segment) flash step.

    q: [B,bq,Hkv,G,D]; k/v: [B,skv,Hkv,D]; mask: [bq,skv] or
    [B,bq,skv] bool, or None.  Returns unnormalized partials
    (s_max, p_sum, p_v) in fp32 (float64 for float64 inputs).
    """
    s = torch.einsum("bqhgd,bkhd->bhgqk", _wide(q), _wide(k)) * scale
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
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p, _wide(v))
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


def _lse(acc) -> torch.Tensor:
    """Log-sum-exp of each row's scaled visible scores, m + log l
    [B,H,G,bq]; -inf for a row that sees nothing (l = 0)."""
    m, l, _ = acc
    return torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
                       -math.inf)


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


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    return q_pos[:, None] >= k_pos[None, :]


def _direct(sq: int, skv: int, causal: bool, sparsity: float,
            block_q: int, block_kv: int) -> bool:
    """Whether ``mha`` takes the direct path: decode, tiny shapes and
    non-causal (chunk-bidirectional) attention.  rho block sparsity is
    defined on the blocked causal schedule, so any sparsity > 0 request
    takes the blocked path at the given block sizes."""
    return ((sq * skv <= block_q * block_kv and sparsity == 0.0)
            or sq == 1 or not causal)


def flash_mode(sq: int, skv: int, *, causal: bool, window: int, sink: int,
               sparsity: float, block_q: int, block_kv: int) -> dict:
    """The flash-attention kernel's mode for an ``mha`` call: what
    ``mha`` itself computes — the window (and its sink) only when
    causal, rho only on the blocked causal schedule without a window,
    the block sizes clipped to the lengths as the blocked paths clip
    them."""
    direct = _direct(sq, skv, causal, sparsity, block_q, block_kv)
    if not direct:
        assert sq % min(block_q, sq) == 0, (sq, block_q)
    w = window if causal else 0
    return dict(causal=causal, window=w, sink=sink if w else 0,
                sparsity=0.0 if (direct or w) else sparsity,
                block_q=min(block_q, sq), block_kv=min(block_kv, skv))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        n_kv_heads: int,
        causal: bool = True,
        q_offset: int = 0,
        window: int = 0,
        sink: int = 0,
        sparsity: float = 0.0,
        kv_mask: Optional[torch.Tensor] = None,
        block_q: int = 512,
        block_kv: int = 512) -> torch.Tensor:
    """Multi-head attention with GQA + fidelity knobs.

    q: [B,Sq,Hq,D]; k,v: [B,Skv,Hkv,D].  Returns [B,Sq,Hq,D].
    ``q_offset``: absolute position of q[0] relative to k[0] (chunk-wise
    generation, where Skv > Sq).  ``kv_mask``: optional [B,Skv] per-row
    KV validity (direct path only) — one launch serves rows with
    different fidelity windows/sparsities.

    A CUDA tensor without ``kv_mask`` runs the flash-attention kernel
    in the mode this function computes (``flash_mode``).  With
    ``kv_mask`` the direct masked segment stays plain torch on every
    device: the reference runs that segment as jnp on the TPU too, so it
    is not the plain version of a kernel.

    On DTensors (a sharded step) it runs on each shard's local heads
    and batch rows (``logical.per_shard``) and dispatches by the local
    tensors' device.
    """
    if isinstance(q, DTensor):
        def local(q, k, v, kv_mask):
            return mha(q, k, v, n_kv_heads=k.shape[2], causal=causal,
                       q_offset=q_offset, window=window, sink=sink,
                       sparsity=sparsity, kv_mask=kv_mask, block_q=block_q,
                       block_kv=block_kv)
        return per_shard(local, (q, k, v, kv_mask),
                         ((0, 2),) * 3 + ((0, None),), (0, 2),
                         batch=q.shape[0], heads=(q.shape[2], k.shape[2]))
    if kv_mask is None and q.device.type == "cuda":
        from repro_torch.kernels.flash_attention.ops import flash_mha
        return flash_mha(q, k, v, n_kv_heads=n_kv_heads, q_offset=q_offset,
                         **flash_mode(q.shape[1], k.shape[1], causal=causal,
                                      window=window, sink=sink,
                                      sparsity=sparsity, block_q=block_q,
                                      block_kv=block_kv))
    return mha_plain(q, k, v, n_kv_heads=n_kv_heads, causal=causal,
                     q_offset=q_offset, window=window, sink=sink,
                     sparsity=sparsity, kv_mask=kv_mask, block_q=block_q,
                     block_kv=block_kv)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              n_kv_heads: int, causal: bool = True, q_offset: int = 0,
              window: int = 0, sink: int = 0, sparsity: float = 0.0,
              kv_mask: Optional[torch.Tensor] = None, block_q: int = 512,
              block_kv: int = 512, return_lse: bool = False):
    """``mha`` in plain PyTorch on any device (the reference's jnp
    body): the direct path, or the static block schedules — the causal
    block-triangular schedule with the optional rho keep list, and sink
    + sliding window as per-q-block static KV segments.  With
    ``return_lse`` it returns ``(out, lse)``, lse [B,Hq,Sq] the fp32
    log-sum-exp of each row's scaled visible scores (-inf for a row that
    sees nothing): what the flash kernel's backward recomputes P from."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    dtype = q.dtype
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    qg = _group(q, n_kv_heads)

    # ---- direct path: decode / tiny shapes / non-causal ------------------
    if _direct(sq, skv, causal, sparsity, block_q, block_kv):
        mask = None
        if causal:
            q_pos = q_offset + torch.arange(sq, device=dev)
            k_pos = torch.arange(skv, device=dev)
            mask = _causal_mask(q_pos, k_pos)
            if window:
                mask &= (k_pos[None, :] > q_pos[:, None] - window) | \
                        (k_pos[None, :] < sink)
        if kv_mask is not None:
            km = kv_mask[:, None, :]                     # [B,1,Skv]
            mask = km if mask is None else mask[None] & km
        acc = _segment_attn(qg, k, v, mask, scale)
        out = _finalize(acc, dtype).permute(0, 3, 1, 2, 4).reshape(
            b, sq, hq, d)
        return (out, _lse(acc).reshape(b, hq, sq)) if return_lse else out
    assert kv_mask is None, "kv_mask is only supported on the direct path"

    # ---- blocked paths -----------------------------------------------------
    block_q = min(block_q, sq)
    block_kv = min(block_kv, skv)
    assert sq % block_q == 0, (sq, block_q)
    n_q = sq // block_q
    g = hq // n_kv_heads

    outs, lses = [], []
    for i in range(n_q):
        q_blk = qg[:, i * block_q:(i + 1) * block_q]
        q_lo = q_offset + i * block_q
        q_hi = q_lo + block_q
        q_pos = q_lo + torch.arange(block_q, device=dev)
        acc = _init_acc(b, n_kv_heads, g, block_q, d, device=dev)

        if window:
            # sink prefix + sliding window (static slices; exact FLOPs)
            segs: List[Tuple[int, int]] = []
            if sink:
                segs.append((0, min(sink, skv)))
            w_lo = max(sink, q_lo - window + 1)
            # round down for block alignment, but never below the sink
            # prefix (it has its own segment; overlap would double-count)
            w_lo = max((w_lo // block_kv) * block_kv, sink)
            segs.append((w_lo, min(q_hi, skv)))
            for lo, hi in segs:
                if lo >= hi:
                    continue
                k_pos = lo + torch.arange(hi - lo, device=dev)
                msk = _causal_mask(q_pos, k_pos)
                msk &= (k_pos[None, :] > q_pos[:, None] - window) | \
                       (k_pos[None, :] < sink)
                acc = _merge(acc, _segment_attn(q_blk, k[:, lo:hi],
                                                v[:, lo:hi], msk, scale))
        else:
            # causal block-triangular schedule; optional rho block sparsity
            n_kv_for_q = (q_hi + block_kv - 1) // block_kv
            if sparsity > 0.0:
                keep = sparse_keep_list(1, [n_kv_for_q], sparsity)[0]
            else:
                keep = list(range(n_kv_for_q))
            for j in keep:
                lo, hi = j * block_kv, min((j + 1) * block_kv, skv)
                msk = None
                if hi > q_lo:  # diagonal/edge segment: elementwise mask
                    msk = _causal_mask(q_pos, lo + torch.arange(
                        hi - lo, device=dev))
                acc = _merge(acc, _segment_attn(q_blk, k[:, lo:hi],
                                                v[:, lo:hi], msk, scale))

        outs.append(_finalize(acc, dtype).permute(0, 3, 1, 2, 4).reshape(
            b, block_q, hq, d))
        lses.append(_lse(acc).reshape(b, hq, block_q))
    out = torch.cat(outs, dim=1)
    return (out, torch.cat(lses, dim=2)) if return_lse else out


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
    (the CUDA kernel for CUDA tensors, the plain version for CPU ones).
    The in-chunk segment continues each row's online softmax from them
    and divides: on the card in bf16 at D 96 or 128 (``flash_attention.
    ops.seeded_path``) one launch of the tensor-core kernel's seeded form
    (``flash_mha_seeded``), which also lays the output out; elsewhere
    (CPU tensors, fp32, other head dims) plain PyTorch, as in the
    reference (``flash_attention.ref.flash_mha_seeded_ref``: the fp32
    segment, the merge before the softmax divide, the layout).  No
    contiguous context is materialized.  ``sink``/``chunk_tokens`` give
    the valid prefixes of the sink/ring pages so neither form computes
    dead page tails.

    Traced as two device spans (``profiler/trace.py``):
    ``device.attn.context`` over the paged segment and
    ``device.attn.chunk`` over the in-chunk segment, the merge and the
    output's layout; counted in ``flash_mha.launches_seeded`` or
    ``flash_mha.plain_segments``.
    """
    # late imports: keep ``models`` importable without the kernel package,
    # and out of the import cycle through ``profiler``
    from repro_torch.kernels.flash_attention.ops import flash_mha_seeded
    from repro_torch.kernels.paged_attention.ops import paged_chunk_attention
    from repro_torch.profiler import trace
    with trace.device_span("device.attn.context", q.device):
        ctx = paged_chunk_attention(q, k_pages, v_pages, block_table,
                                    page_mask, sink=sink,
                                    chunk_tokens=chunk_tokens)
    with trace.device_span("device.attn.chunk", q.device):
        return flash_mha_seeded(q, chunk_k, chunk_v, *ctx,
                                n_kv_heads=n_kv_heads)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, n_kv_heads: int,
                     cache_len, window: int = 0,
                     sink: int = 0) -> torch.Tensor:
    """Single-token decode over a KV cache.

    q: [B,1,Hq,D]; caches: [B,Smax,Hkv,D]; ``cache_len``: [B] or scalar
    int count of valid cache entries (the new token's KV must already be
    written).  With ``window``, only the last ``window`` valid entries
    and the first ``sink`` stay visible.  A row with no valid entry
    gives NaN, as the reference's softmax over all ``-inf`` does.  On
    DTensors, per shard of batch rows and heads, as ``mha``; caches
    whose sequence is split over the mesh go to
    ``_decode_attention_split_sequence``.
    """
    if isinstance(k_cache, DTensor) and _sequence_split(k_cache):
        return _decode_attention_split_sequence(
            q, k_cache, v_cache, cache_len=cache_len, window=window,
            sink=sink)
    if isinstance(q, DTensor):
        ln_dims = (0, None) if isinstance(cache_len, torch.Tensor) \
            and cache_len.ndim else None

        def local(q, k_cache, v_cache, cache_len):
            return decode_attention(q, k_cache, v_cache,
                                    n_kv_heads=k_cache.shape[2],
                                    cache_len=cache_len, window=window,
                                    sink=sink)
        return per_shard(local, (q, k_cache, v_cache, cache_len),
                         ((0, 2),) * 3 + (ln_dims,), (0, 2),
                         batch=q.shape[0],
                         heads=(q.shape[2], k_cache.shape[2]))
    b, sq, hq, d = q.shape
    smax = k_cache.shape[1]
    scale = 1.0 / math.sqrt(d)
    qg = _group(q, n_kv_heads)
    k_pos = torch.arange(smax, device=q.device)
    ln = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = k_pos[None, :] < ln                                   # [B,S]
    if window:
        last = ln - 1
        valid &= (k_pos[None, :] > last - window) | (k_pos[None, :] < sink)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float()) \
        * scale
    s = torch.where(valid[:, None, None, None], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v_cache.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def _sequence_split(cache: DTensor) -> bool:
    """Whether a [B,S,H,D] cache's slots are split over a mesh dim of
    more than one rank."""
    return any(isinstance(p, Shard) and p.dim == 1 and n > 1
               for p, n in zip(cache.placements, cache.device_mesh.shape))


def _decode_attention_split_sequence(q, k_cache, v_cache, *, cache_len,
                                     window, sink):
    """``decode_attention`` over caches whose slots are split over mesh
    dims (the layout ``lowering.cache_shardings`` gives caches whose KV
    heads do not divide over ``model``): every rank attends to its own
    block of slots, and the partial softmax statistics are combined
    across the split, flash-decoding's combine (an all-reduce of the
    row max, then one of the rescaled sums and outputs), which is what
    GSPMD emits for the reference.  The cache is never gathered.  Rows
    go over the batch axes that do not split the slots where the batch
    divides; KV heads stay split where the cache splits them whole."""
    mesh = k_cache.device_mesh
    pl = k_cache.placements
    seq = [isinstance(p, Shard) and p.dim == 1 for p in pl]
    heads = [isinstance(p, Shard) and p.dim == 2
             and k_cache.shape[2] % n == 0 for p, n in zip(pl, mesh.shape)]
    rows = batch_split(mesh, q.shape[0], seq)
    row_pl = tuple(Shard(0) if rows[i] else Shard(2) if heads[i]
                   else Replicate() for i in range(mesh.ndim))
    kv_pl = tuple(Shard(1) if seq[i] else p for i, p in enumerate(row_pl))
    q_l = as_dtensor(q, mesh).redistribute(mesh, row_pl).to_local()
    k_l = k_cache.redistribute(mesh, kv_pl).to_local()
    v_l = v_cache.redistribute(mesh, kv_pl).to_local()
    off = local_box(k_cache.shape, mesh, kv_pl)[0][1]
    ln = cache_len
    if isinstance(ln, torch.Tensor) and ln.ndim:
        ln_pl = tuple(Shard(0) if r else Replicate() for r in rows)
        ln = as_dtensor(ln, mesh).redistribute(mesh, ln_pl).to_local()

    b, sq, hq, d = q_l.shape
    scale = 1.0 / math.sqrt(d)
    qg = _group(q_l, k_l.shape[2])
    k_pos = off + torch.arange(k_l.shape[1], device=q_l.device)
    ln = torch.as_tensor(ln, device=q_l.device).reshape(-1, 1)
    valid = k_pos[None, :] < ln                                   # [B,S]
    if window:
        last = ln - 1
        valid &= (k_pos[None, :] > last - window) | (k_pos[None, :] < sink)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_l.float()) * scale
    s = torch.where(valid[:, None, None, None], s, -math.inf)
    m = s.amax(-1) if s.shape[-1] else s.new_full(s.shape[:-1], -math.inf)

    def combine(t, op):
        # one all-reduce over the mesh dims that split the slots (the
        # other dims are left as they are: no communication there)
        part = [Partial(op) if x else Replicate() for x in seq]
        return DTensor.from_local(t, mesh, part, run_check=False) \
            .redistribute(mesh, [Replicate()] * mesh.ndim).to_local()

    m = combine(m, "max")
    m_safe = torch.where(m == -math.inf, 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v_l.float())
    lo = combine(torch.cat([p.sum(-1)[..., None], o], -1), "sum")
    o = lo[..., 1:] / lo[..., :1]
    out = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q_l.dtype)
    return DTensor.from_local(out, mesh, row_pl, run_check=False)
