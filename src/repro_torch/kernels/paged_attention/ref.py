"""Plain PyTorch versions of the two paged attention kernels.

``paged_chunk_attention_ref`` is what the chunk kernel
(``csrc/paged_chunk_attention.cu``) computes, written with gathers and
einsums: it returns ONLINE-SOFTMAX PARTIALS over the visible page set so
the caller can merge them with the chunk's own fresh KV segment
(``models.attention.paged_mha``).  ``paged_decode_attention_ref`` is the
decode kernel's (``csrc/paged_decode_attention.cu``): it gathers the
logical KV sequence through the block table and runs the dense
``models.attention.decode_attention``.  The CPU tests run both, and
``chip_smoke.py`` holds each kernel against its plain version on the
card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.attention import decode_attention

NEG_INF = -1e30


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """pages [P_total, page, Hkv, D]; block_table [B, n] -> [B, n*page, Hkv, D]."""
    b, n = block_table.shape
    _, page, hkv, d = pages.shape
    out = pages[block_table.reshape(-1).long()]      # [B*n, page, Hkv, D]
    return out.reshape(b, n * page, hkv, d)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """q [B,Hq,D] -> [B,Hq,D]; lengths [B] = valid tokens per sequence.
    A sequence of length 0 gives NaN (the oracle's softmax over no
    visible token), where the kernel gives 0 as the TPU kernel does."""
    hkv = k_pages.shape[2]
    k = gather_pages(k_pages, block_table)
    v = gather_pages(v_pages, block_table)
    out = decode_attention(q[:, None], k, v, n_kv_heads=hkv,
                           cache_len=lengths)
    return out[:, 0]


def paged_chunk_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_table: torch.Tensor, page_mask, *,
                              sink: int = 0, chunk_tokens: int = 0):
    """Chunk-query paged attention partials over the visible page set.

    q [B,Sq,Hq,D]; pages [P_total, page, Hkv, D]; block_table [B, n];
    page_mask [B, n*page] bool — visible context tokens in TABLE order
    (entry 0's tokens first, then entry 1's, ...), with page tails past
    each page's valid extent already masked off by the caller.
    ``page_mask=None`` (layout hint required) means "every valid token
    visible" and skips per-score masking entirely.

    ``sink``/``chunk_tokens`` are an optional layout hint: table entry 0
    holds at most ``sink`` valid tokens and every later entry at most
    ``chunk_tokens``, so the always-masked page tails are skipped (the
    compact-extent path).  The partials are identical either way:
    masked tokens contribute m=NEG_INF, p=0.

    Returns unfinalized fp32 partials in the ``attention._merge`` layout:
    m, l [B, Hkv, G, Sq] and acc [B, Hkv, G, Sq, D] (acc unnormalized),
    with m == NEG_INF where a query row saw no visible token.
    """
    b, sq, hq, d = q.shape
    page = k_pages.shape[1]
    hkv = k_pages.shape[2]
    g = hq // hkv
    n = block_table.shape[1]
    scale = 1.0 / math.sqrt(d)
    s0, tc = min(sink, page), min(chunk_tokens, page)
    bt = block_table.long()
    if page_mask is None:
        assert sink and chunk_tokens, \
            "page_mask=None needs the sink/chunk_tokens layout hint"
    if sink and chunk_tokens and (s0 < page or (n > 1 and tc < page)):
        # compact layout: valid prefixes only
        k = k_pages[bt[:, 0], :s0]                   # [B, s0, Hkv, D]
        v = v_pages[bt[:, 0], :s0]
        if n > 1:
            kr = k_pages[bt[:, 1:].reshape(-1), :tc].reshape(
                b, (n - 1) * tc, hkv, d)
            vr = v_pages[bt[:, 1:].reshape(-1), :tc].reshape(
                b, (n - 1) * tc, hkv, d)
            k = torch.cat([k, kr], dim=1)
            v = torch.cat([v, vr], dim=1)
        if page_mask is not None:
            cols = [torch.arange(s0)] + [(1 + r) * page + torch.arange(tc)
                                         for r in range(n - 1)]
            page_mask = page_mask[:, torch.cat(cols).to(page_mask.device)]
    else:
        k = gather_pages(k_pages, bt)                # [B, n*page, Hkv, D]
        v = gather_pages(v_pages, bt)
    qg = q.reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if page_mask is None:       # every compact token visible: no select
        m = torch.amax(s, dim=-1)                    # [B,Hkv,G,Sq]
        p = torch.exp(s - m[..., None])
    else:
        vis = page_mask[:, None, None, None, :]
        s = torch.where(vis, s, NEG_INF)
        m = torch.amax(s, dim=-1)
        p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return m, l, acc


def paged_decode_partials_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_table: torch.Tensor,
                              lengths: torch.Tensor, unit: int):
    """The decode kernel's split over the sequence, plain: per stream b
    and unit u of ``unit`` tokens ([u * unit, (u + 1) * unit) of the
    logical sequence, clamped to [0, n * page]), the fp32 online-softmax
    partials of every query head over the unit's visible tokens (those
    before ``lengths[b]``): m, l [B, Hq, U] and acc [B, Hq, U, D]
    unnormalized, U = ceil(n * page / unit); m = NEG_INF, l = acc = 0 for
    a unit with no visible token.  ``combine_decode_partials`` merges
    them (tests only)."""
    b, hq, d = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    k = gather_pages(k_pages, block_table).float()   # [B, T, Hkv, D]
    v = gather_pages(v_pages, block_table).float()
    t = k.shape[1]
    units = -(-t // unit)
    qg = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bthd->bhgt", qg, k) / math.sqrt(d)
    pos = torch.arange(t, device=q.device)
    ln = lengths.to(q.device).long().clamp(0, t)
    vis = pos[None, :] < ln[:, None]                 # [B, T]
    m = torch.full((b, hkv, g, units), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, units), device=q.device)
    acc = torch.zeros((b, hkv, g, units, d), device=q.device)
    for u in range(units):
        sl = slice(u * unit, min((u + 1) * unit, t))
        vu = vis[:, None, None, sl]
        su = torch.where(vu, s[..., sl], NEG_INF)
        mu = su.amax(-1)
        pu = torch.where(vu, torch.exp(su - mu[..., None]), 0.0)
        m[..., u] = mu
        l[..., u] = pu.sum(-1)
        acc[..., u, :] = torch.einsum("bhgt,bthd->bhgd", pu, v[:, sl])
    return (m.reshape(b, hq, units), l.reshape(b, hq, units),
            acc.reshape(b, hq, units, d))


def combine_decode_partials(m: torch.Tensor, l: torch.Tensor,
                            acc: torch.Tensor, out_dtype=torch.float32):
    """Merges the units' partials of ``paged_decode_partials_ref`` (the
    kernel's combine pass, plain): softmax over all units, a stream whose
    units saw nothing gives 0 (as the TPU kernel: l == 0 -> 1)."""
    mm = m.amax(-1, keepdim=True)                    # [B, Hq, 1]
    w = torch.where(m == NEG_INF, 0.0, torch.exp(m - mm))
    ll = (l * w).sum(-1)
    aa = (acc * w[..., None]).sum(-2)
    return (aa / torch.where(ll == 0, 1.0, ll)[..., None]).to(out_dtype)
