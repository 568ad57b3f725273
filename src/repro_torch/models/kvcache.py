"""Sink + ring KV cache helpers (paper SS2.1 "sink+local").

Token caches (the registry's transformer and hybrid families): slots
[0, sink) hold the attention sink and slots [sink, cap) are a ring over
the sliding window (``capacity``, ``ring_dest``, ``write_token``,
``n_valid``, ``place_prefill``).  When ``cap >= seq_len`` the ring
degenerates to a plain linear cache (dest == pos), so the same code
serves the full cache and the windowed one.  The AR-DiT's ring batched
cache appends a chunk per stream at its ring slot (``chunk_slot``,
``write_block{,_layers}``).

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
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.logical import as_dtensor, local_box, per_shard

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


def capacity(seq_len: int, window: int, sink: int) -> int:
    """Cache capacity in tokens for a stream of ``seq_len``."""
    if window:
        return min(seq_len, sink + window)
    return seq_len


def ring_dest(pos: torch.Tensor, cap: int, sink: int) -> torch.Tensor:
    """Write slot for absolute position ``pos`` [B] (int32)."""
    ring = cap - sink
    wrapped = sink + (pos - sink) % max(ring, 1)
    return torch.where(pos < cap, torch.clamp(pos, max=cap - 1),
                       wrapped).to(torch.int32)


def write_token(cache: torch.Tensor, new: torch.Tensor,
                dest: torch.Tensor) -> torch.Tensor:
    """cache [B,cap,H,D]; new [B,1,H,D]; dest [B] -> the cache, written
    IN PLACE and returned (the reference returns an updated copy; a copy
    of a full-width cache per token would dominate decode).  A ``dest``
    past the end writes the last slot, as the reference's
    ``dynamic_update_slice`` clamps its start; the cast is the
    reference's (``to_fp8_e4m3`` into an e4m3 cache)."""
    dest = torch.clamp(dest.long(), 0, cache.shape[1] - 1)
    if cache.dtype == torch.float8_e4m3fn and new.dtype != cache.dtype:
        new = to_fp8_e4m3(new)
    if isinstance(cache, DTensor):
        return _write_token_local(cache, new, dest)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, dest] = new[:, 0].to(cache.dtype)
    return cache


def _write_token_local(cache: DTensor, new: torch.Tensor,
                       dest: torch.Tensor) -> DTensor:
    """``write_token`` into a sharded cache, in place: every rank writes
    the rows of its batch block whose slot lies in its block of slots
    into its local block (one indexed write of the rows; no gather and
    no pass over the cache).  The token is laid out as the cache with
    its one slot replicated; ``dest`` (clamped) as the cache's rows."""
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    tok_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1
                   else p for p in pl)
    row_pl = tuple(p if isinstance(p, Shard) and p.dim == 0
                   else Replicate() for p in pl)
    new = as_dtensor(new, mesh).redistribute(mesh, tok_pl).to_local()[:, 0]
    dest = as_dtensor(dest, mesh).redistribute(mesh, row_pl).to_local()
    off, size = local_box(cache.shape, mesh, pl)
    local = cache.to_local()
    if not size[1] or not local.shape[0]:
        return cache
    slot = dest - off[1]
    hit = (slot >= 0) & (slot < size[1])
    slot = torch.clamp(slot, 0, size[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    hit = hit.reshape((-1,) + (1,) * (local.ndim - 2))
    local[rows, slot] = torch.where(hit, new.to(local.dtype),
                                    local[rows, slot])
    return cache


def n_valid(pos: torch.Tensor, cap: int) -> torch.Tensor:
    """Number of resident (valid) cache entries after writing ``pos``."""
    return torch.clamp(pos + 1, max=cap)


def place_prefill(k: torch.Tensor, cap: int, sink: int,
                  window: int) -> torch.Tensor:
    """[B,S,H,D] -> [B,cap,H,D]: full copy if it fits, else sink+ring gather.

    Ring slot r holds the LAST token t < S with (t - sink) % ring == r.
    Gather (not scatter) so duplicate ring slots resolve deterministically.
    On a DTensor, per shard of batch rows and heads (the pad and the
    gather have no usable DTensor rule on every torch version).
    """
    if isinstance(k, DTensor):
        return per_shard(lambda t: place_prefill(t, cap, sink, window), (k,),
                         ((0, 2),), (0, 2), batch=k.shape[0],
                         heads=(k.shape[2],))
    b, s = k.shape[:2]
    if cap >= s:
        return torch.nn.functional.pad(k, (0, 0) * (k.ndim - 2)
                                       + (0, cap - s))
    assert window > 0, (
        f"cache capacity {cap} < sequence {s} without a sliding window "
        f"— caller must size max_len to the full prefill length")
    ring = cap - sink
    slots = torch.arange(cap, device=k.device)
    r = slots - sink
    ring_tok = sink + r + ((s - 1 - sink - r) // ring) * ring
    tok_idx = torch.where(slots < sink, slots, ring_tok)
    valid = (tok_idx >= 0) & (tok_idx < s)
    out = k[:, torch.clamp(tok_idx, 0, s - 1)]
    shape = (1, cap) + (1,) * (k.ndim - 2)
    return out * valid.reshape(shape).to(k.dtype)


def chunk_slot(chunk_idx, window_chunks: int, sink: int,
               chunk_tokens: int):
    """First-token slot of absolute chunk ``chunk_idx`` in the
    chunk-granular ring: slots [0, sink) hold the attention sink and the
    ring holds ``window_chunks`` chunks of ``chunk_tokens`` each.
    ``chunk_idx`` may be an int or a per-stream integer array/tensor."""
    return sink + (chunk_idx % window_chunks) * chunk_tokens


def write_block(cache: torch.Tensor, new: torch.Tensor,
                dest: torch.Tensor) -> torch.Tensor:
    """cache [B,cap,...]; new [B,T,...]; dest [B] first-token slot ->
    the cache, written IN PLACE and returned.

    Block-granular sibling of ``write_token``: a contiguous T-token block
    per batch row at a per-row slot (the ring batched cache appends one
    chunk's KV per stream this way), as one indexed write.  A slot past
    ``cap - T`` writes the last T slots, as the reference's
    ``dynamic_update_slice`` clamps its start; the cast is the
    reference's (``to_fp8_e4m3`` into an e4m3 cache)."""
    write_block_layers(cache[None], new[None], dest)
    return cache


def write_block_layers(cache: torch.Tensor, new: torch.Tensor,
                       dest: torch.Tensor) -> torch.Tensor:
    """``write_block`` over a leading layer axis, IN PLACE: cache
    [L,B,cap,...]; new [L,B,T,...]; dest [B]."""
    b, t = new.shape[1], new.shape[2]
    dest = torch.clamp(torch.as_tensor(dest, device=cache.device).long(),
                       0, cache.shape[2] - t)
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = dest[:, None] + torch.arange(t, device=cache.device)[None, :]
    if cache.dtype == torch.float8_e4m3fn and new.dtype != cache.dtype:
        new = to_fp8_e4m3(new)
    cache[:, rows, cols] = new.to(cache.dtype)
    return cache


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


def write_cast(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` with the reference's cast: an e4m3 destination
    takes ``to_fp8_e4m3(src)``; a DTensor source is laid out as the
    destination first (an in-place copy keeps the destination's
    layout)."""
    if dst.dtype == torch.float8_e4m3fn and src.dtype != dst.dtype:
        src = to_fp8_e4m3(src)
    if isinstance(dst, DTensor) and isinstance(src, DTensor) \
            and src.placements != dst.placements:
        src = src.redistribute(dst.device_mesh, dst.placements)
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
        write_cast(pool[:, int(pg), :t], new[:, i])


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
        write_cast(pool[:, int(pg), :t, head_offset:head_offset + hs],
               new[:, i])
