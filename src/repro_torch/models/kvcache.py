"""Paged sink + ring KV cache helpers (paper SS2.1 "sink+local").

The page-granular pool (``serve/batcher.py::KVPool``) keeps KV as
[L, n_pages, page_tokens, Hkv, Dh] and each stream owns a page *table*:
entry 0 = cond sink page, entry 1+r = ring slot r, chunk c in entry
1 + c % window_chunks.  The helpers below are pure permutations of pool
rows; ``gather_pages`` reassembles the contiguous sink+ring context the
``gather`` context backend hands to ``mha``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# |x| above this rounds past e4m3fn's largest finite value (448): the
# JAX reference's ``astype(float8_e4m3fn)`` gives NaN there, while
# torch's cast saturates to +-448
FP8_E4M3_NAN_ABOVE = 464.0


def to_fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Cast to ``float8_e4m3fn`` with the JAX reference's overflow
    semantics: |x| > 464 (and +-inf, NaN) become NaN instead of
    saturating, so an fp8 stream whose KV overflows behaves as it does
    in the reference."""
    bad = ~(x.abs() <= FP8_E4M3_NAN_ABOVE)
    return torch.where(bad, torch.nan, x).to(torch.float8_e4m3fn)


def chunk_slot(chunk_idx, window_chunks: int, sink: int,
               chunk_tokens: int):
    """First-token slot of absolute chunk ``chunk_idx`` in the
    chunk-granular ring: slots [0, sink) hold the attention sink and the
    ring holds ``window_chunks`` chunks of ``chunk_tokens`` each.
    ``chunk_idx`` may be an int or a per-stream integer array/tensor."""
    return sink + (chunk_idx % window_chunks) * chunk_tokens


def pages_per_stream(window_chunks: int) -> int:
    """Pages a resident stream owns: one cond sink page + the ring."""
    return 1 + window_chunks


def page_of_chunk(chunk_idx: int, window_chunks: int) -> int:
    """Page-table entry holding absolute chunk ``chunk_idx`` (the ring
    slot of ``chunk_slot`` shifted past the sink entry)."""
    return 1 + chunk_idx % window_chunks


def gather_pages(pool: torch.Tensor, tables: torch.Tensor, sink: int,
                 chunk_tokens: int, n_ring: int) -> torch.Tensor:
    """pool [L,n_pages,P,...]; tables [b, 1+W] page ids ->
    [L, b, sink + n_ring*chunk_tokens, ...].

    Reassembles, per stream, the contiguous sink+ring context: tokens
    [0, sink) from the sink page (table entry 0), ring slot r at
    [sink + r*chunk_tokens, sink + (r+1)*chunk_tokens) from table entry
    1+r, sliced to the first ``n_ring`` ring slots (the sub-batch's
    resident extent).  A pure gather: bitwise-exact."""
    tables = tables.long()
    sink_part = pool[:, tables[:, 0], :sink]
    if n_ring == 0:
        return sink_part
    ring = pool[:, tables[:, 1:1 + n_ring], :chunk_tokens]
    l, b = ring.shape[:2]
    ring = ring.reshape((l, b, n_ring * chunk_tokens) + ring.shape[4:])
    return torch.cat([sink_part, ring], dim=2)


def mask_to_pages(mask: np.ndarray, n_ring: int, sink: int,
                  chunk_tokens: int, page_tokens: int) -> np.ndarray:
    """Contiguous sink+ring visibility mask [B, >= sink + n_ring*tc] ->
    page-coordinate mask [B, (1+n_ring)*page_tokens] in TABLE order
    (entry 0 = sink page, entry 1+r = ring slot r) for the paged
    attention path.  Pages are ``page_tokens`` wide but only partially
    valid — ``sink`` tokens on the sink page, ``chunk_tokens`` on ring
    pages — so page tails come out False regardless of the input mask.
    """
    b = mask.shape[0]
    out = np.zeros((b, (1 + n_ring) * page_tokens), bool)
    out[:, :sink] = mask[:, :sink]
    for r in range(n_ring):
        lo = (1 + r) * page_tokens
        out[:, lo:lo + chunk_tokens] = \
            mask[:, sink + r * chunk_tokens:sink + (r + 1) * chunk_tokens]
    return out


def _write(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` with the reference's cast: an e4m3 destination
    takes ``to_fp8_e4m3(src)``."""
    if dst.dtype == torch.float8_e4m3fn and src.dtype != dst.dtype:
        src = to_fp8_e4m3(src)
    dst.copy_(src)


def pool_write_pages(pool: torch.Tensor, new: torch.Tensor,
                     pages: Sequence[int]) -> None:
    """pool [L,n_pages,P,...]; new [L,b,T,...] (T <= P); pages [b].

    Writes one T-token block per stream at token 0 of its destination
    page, IN PLACE.  The JAX reference donates the pool buffer to a
    jitted functional update for the same effect; here the pool tensor
    is simply mutated.  The block is cast to the pool dtype as the
    reference's ``astype`` casts it: into an fp8-e4m3 pool through
    ``to_fp8_e4m3`` (NaN above 464, where ``copy_`` would saturate to
    448), into any other pool by ``copy_`` (which is also where an
    fp8-rounded block lands back in a bf16 pool)."""
    t = new.shape[2]
    for i, pg in enumerate(pages):
        _write(pool[:, int(pg), :t], new[:, i])


def pool_write_pages_heads(pool: torch.Tensor, new: torch.Tensor,
                           pages: Sequence[int], head_offset: int) -> None:
    """pool [L,n_pages,P,Hkv,D]; new [L,b,T,h_sub,D] (T <= P, h_sub <=
    Hkv - head_offset); pages [b].

    Head-sliced sibling of ``pool_write_pages``: writes each block at
    token 0 of its destination page and KV-head offset ``head_offset``,
    IN PLACE — the elastic-SP donor pool holds only its half of a
    stream's KV heads (Ulysses head partition, paper App. C.4), so its
    appends touch only that half.  Cast as in ``pool_write_pages``."""
    t, hs = new.shape[2], new.shape[3]
    for i, pg in enumerate(pages):
        _write(pool[:, int(pg), :t, head_offset:head_offset + hs],
               new[:, i])
