"""Batched multi-stream serving executor (continuous cross-request
batching at denoise-step granularity).

Every scheduler iteration composes a *micro-batch* from the
credit-ordered runnable set (lowest credit first, up to ``max_batch``),
splits it into sub-batches (same fidelity, or — fused dispatch — same
KV dtype), and advances each sub-batch by ONE denoise step with a
single batched ``ardit.denoise_step_paged`` call over a PAGE-GRANULAR
device KV pool (SS4.1's state plane): each stream owns a cond sink page
plus a ring of chunk pages through a per-stream page table, and
attention reads the pool in place through ``attention.paged_mha`` ->
``kernels/paged_attention`` (the CUDA kernel on the card).  Streams join
and leave the batch at step boundaries; on admission pressure the
executor evicts the highest-credit resident (host spill, bit-exact
restore) — or, with ``page_evict``, single ring pages first — instead
of failing.  Measured whole-chunk wall time feeds the latency EMAs so
BMPR budgets stay honest (re-profiling).

``context_backend="gather"`` instead assembles each sub-batch's
contiguous sink+ring context through the page tables once per chunk
boundary (``KVPool.gather``) and steps with ``ardit.denoise_step``
(``attention.mha``: the flash-attention kernel on the card when every
context token is visible, the masked direct path otherwise).

Across lanes (``serve.lanes.LanePool``): a stream is detached and
adopted whole for a migration (``export_stream`` / ``import_stream``),
and an elastic-SP borrow is an ``SPLink`` on the home executor — solo
mode runs the head-split ``ardit.denoise_step_paged_sp`` over both
lanes' pools, batch mode serves the stream as an ``SPGuest`` row of the
donor's own micro-batch.  The step cache (``FidelityConfig.cache !=
"off"``) waits for its slice (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import queues
from repro_torch.core.fidelity import FidelityConfig
from repro_torch.core.state_plane import AsyncTransferEngine, PagedKVPool
from repro_torch.core.types import Stream
from repro_torch.models import ardit as A
from repro_torch.models import kvcache
from repro_torch.serve.executor import (EMA_DECAY, ChunkExecutor,
                                        ServedStream, chunk_noise,
                                        cond_noise)


def compose_batch(sids: Sequence[int],
                  fidelity_of: Callable[[int], FidelityConfig],
                  max_batch: int, fuse: bool = False) -> List[List[int]]:
    """Credit-ordered micro-batch composition.

    ``sids`` is the runnable set already ordered by service credit
    ascending (``queues.next_dispatch_set``).  Takes the lowest-credit
    ``max_batch`` streams and splits them into same-fidelity sub-batches
    (``FidelityConfig.key``), preserving credit order within and across
    groups — the first group contains the most urgent stream.

    ``fuse=True`` groups by **quantization dtype only** (the fused
    heterogeneous-fidelity dispatch): steps, window, and sparsity are
    per-row data inside ``run_step``, so one launch serves every
    fidelity of a dtype.  The dtype split stays: KV quantization is a
    property of the append path shared by the whole launch.
    """
    groups: Dict[Any, List[int]] = {}
    for sid in list(sids)[:max_batch]:
        fid = fidelity_of(sid)
        key = fid.quant if fuse else fid.key
        groups.setdefault(key, []).append(sid)
    return list(groups.values())


class PageLedger:
    """Host-side page bookkeeping of the device pool (no KV values).

    LIFO free list (O(1) pop/push), per-stream page tables (entry 0 =
    cond sink page, entry 1+r = ring slot r), per-stream chunk counts,
    and the set of spilled streams.  Residency is mirrored into a
    ``core.state_plane.PagedKVPool`` so the real executor and the
    simulator share one accounting model (and one invariant checker).
    """

    def __init__(self, n_pages: int, pages_per_stream: int):
        self.n_pages = n_pages
        self.pages_per_stream = pages_per_stream
        self._free: List[int] = list(range(n_pages))
        self.tables: Dict[int, np.ndarray] = {}
        self.chunks: Dict[int, int] = {}
        self.spilled: set = set()
        self.accounting = PagedKVPool(n_pages)
        # partial-window residency: absolute chunk indices whose ring
        # page was individually evicted (table entry -1, KV DISCARDED —
        # a degradation, not a spill).  The set survives whole-stream
        # spill/restore (the restored page holds zeros, not the lost
        # KV) and is pruned as chunks age out of the ring.
        self.dropped: Dict[int, set] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_admit(self) -> bool:
        return len(self._free) >= self.pages_per_stream

    def resident(self, sid: int) -> bool:
        return sid in self.tables

    def resident_sids(self) -> List[int]:
        return list(self.tables)

    def take(self, sid: int, chunks: int = 0) -> np.ndarray:
        """Allocate a page table for ``sid`` (admission or restore)."""
        assert sid not in self.tables, f"stream {sid} already resident"
        assert self.can_admit(), "ledger full: caller must evict first"
        table = np.asarray([self._free.pop()
                            for _ in range(self.pages_per_stream)])
        self.tables[sid] = table
        self.chunks[sid] = chunks
        self.spilled.discard(sid)
        self.accounting.alloc(sid, self.pages_per_stream)
        return table

    def drop(self, sid: int, spill: bool) -> Optional[np.ndarray]:
        """Free ``sid``'s pages; ``spill=True`` keeps it re-admittable.
        Idempotent: dropping a non-resident stream is a no-op (returns
        None) — no double-free."""
        table = self.tables.pop(sid, None)
        if table is None:
            if not spill:
                self.spilled.discard(sid)
                self.chunks.pop(sid, None)
                self.dropped.pop(sid, None)
            return None
        # hole entries (-1: individually evicted ring pages) own nothing
        self._free.extend(int(p) for p in table if int(p) >= 0)
        self.accounting.release(sid)
        if spill:
            self.spilled.add(sid)
        else:
            self.chunks.pop(sid, None)
            self.dropped.pop(sid, None)
        return table

    # ---- partial-window residency (page-granular eviction) -----------------
    def _ring_contents(self, sid: int) -> Dict[int, Optional[int]]:
        """Table ring entry (1..W) -> absolute chunk it currently holds,
        or None for an entry no chunk has reached yet."""
        w = self.pages_per_stream - 1
        n = self.chunks.get(sid, 0)
        held: Dict[int, Optional[int]] = {
            e: None for e in range(1, self.pages_per_stream)}
        for c in range(max(0, n - w), n):
            held[kvcache.page_of_chunk(c, w)] = c
        return held

    def page_eviction_entry(self, sid: int) -> Optional[int]:
        """Ring entry the partial-window ladder would free next for
        ``sid``, or None when the stream is at its residency floor.
        Preference order: an entry no chunk has reached yet (zero
        quality cost), else the entry holding the OLDEST retained chunk
        — never the newest chunk and never the last allocated ring
        entry (so an append into a hole can always self-heal)."""
        table = self.tables.get(sid)
        if table is None:
            return None
        alloc = [e for e in range(1, len(table)) if int(table[e]) >= 0]
        if len(alloc) <= 1:
            return None
        held = self._ring_contents(sid)
        unwritten = [e for e in alloc if held[e] is None]
        if unwritten:
            return unwritten[-1]
        newest = self.chunks.get(sid, 0) - 1
        olds = sorted((held[e], e) for e in alloc if held[e] != newest)
        return olds[0][1] if olds else None

    def evict_page(self, sid: int) -> Optional[int]:
        """Free ONE of ``sid``'s ring pages (partial-window residency:
        the stream stays resident with its effective window reduced by
        one chunk).  The page's KV is DISCARDED, not spilled.  Returns
        the dropped absolute chunk index (or -1 for an unwritten entry),
        None when the stream is at its floor."""
        entry = self.page_eviction_entry(sid)
        if entry is None:
            return None
        held = self._ring_contents(sid)
        table = self.tables[sid]
        self._free.append(int(table[entry]))
        table[entry] = -1
        self.accounting.release_pages(sid, 1)
        c = held[entry]
        if c is not None:
            self.dropped.setdefault(sid, set()).add(c)
        return c if c is not None else -1

    def prune_dropped(self, sid: int) -> None:
        """Forget dropped chunks that aged out of the ring."""
        d = self.dropped.get(sid)
        if d:
            floor = self.chunks.get(sid, 0) - (self.pages_per_stream - 1)
            d.difference_update({c for c in d if c < floor})
            if not d:
                self.dropped.pop(sid, None)

    def append_page(self, sid: int) -> int:
        """Destination page of ``sid``'s next chunk (ring entry).  An
        append into a hole HEALS it: a free page if one exists, else the
        stream steals its own least-valuable sibling ring page."""
        table = self.tables[sid]
        entry = kvcache.page_of_chunk(self.chunks[sid],
                                      self.pages_per_stream - 1)
        if int(table[entry]) < 0:
            if self._free:
                table[entry] = self._free.pop()
                ok = self.accounting.alloc(sid, 1)
                assert ok
            else:
                donor = self._steal_entry(sid, entry)
                table[entry] = int(table[donor])
                table[donor] = -1
        return int(table[entry])

    def _steal_entry(self, sid: int, target: int) -> int:
        """Sibling ring entry whose page a hole-append steals under a
        dry free list: an unreached entry first, else the oldest
        retained chunk's entry (which joins ``dropped``)."""
        table = self.tables[sid]
        alloc = [e for e in range(1, len(table))
                 if e != target and int(table[e]) >= 0]
        assert alloc, f"stream {sid} has no ring page left to steal"
        held = self._ring_contents(sid)
        unwritten = [e for e in alloc if held[e] is None]
        if unwritten:
            return unwritten[-1]
        donor = min(alloc, key=lambda e: held[e])
        self.dropped.setdefault(sid, set()).add(held[donor])
        return donor

    def check(self) -> None:
        """Pool invariants: page conservation, unique ownership, and
        agreement with the mirrored state-plane accounting."""
        allocated = [int(p) for t in self.tables.values()
                     for p in t if int(p) >= 0]
        assert len(set(allocated)) == len(allocated), \
            "page owned by two streams"
        assert len(set(self._free)) == len(self._free), \
            "duplicate page in free list (double-free)"
        assert not set(allocated) & set(self._free), \
            "page both free and allocated"
        assert len(allocated) + len(self._free) == self.n_pages, \
            "page leak: used + free != n_pages"
        assert not self.spilled & set(self.tables), \
            "stream both spilled and resident"
        for sid, t in self.tables.items():
            assert int(t[0]) >= 0, f"stream {sid} lost its sink page"
            assert len(t) == 1 or any(int(p) >= 0 for p in t[1:]), \
                f"stream {sid} degraded below the one-ring-page floor"
        assert self.accounting.used == len(allocated)
        self.accounting.check()


class KVPool:
    """Page-granular device KV pool.

    KV lives as one [L, n_pages, page_tokens, Hkv, Dh] pair on
    ``device``; a resident stream owns ``1 + window_chunks`` pages
    recorded in its page table (cond sink page + ring of chunk pages;
    chunk c lands in table entry ``1 + c % window_chunks``).  On
    admission pressure ``admit`` does NOT raise: the stream is parked
    host-side and the executor decides — evict a victim via
    ``queues.pick_eviction`` and ``restore``, or defer.  Evicted streams
    spill their pages to host memory and are restored bit-exactly.
    """

    def __init__(self, cfg: ModelConfig, params: Any, max_streams: int,
                 engine: Optional[AsyncTransferEngine] = None,
                 device: Any = "cuda"):
        self.cfg, self.params = cfg, params
        self._tc = A.chunk_tokens(cfg)
        self._w = cfg.ardit_window_chunks
        self.page_tokens = max(A.COND_TOKENS, self._tc)
        pps = kvcache.pages_per_stream(self._w)
        self.ledger = PageLedger(max_streams * pps, pps)
        shape = (cfg.n_layers, self.ledger.n_pages, self.page_tokens,
                 cfg.n_kv_heads, cfg.head_dim)
        self.device = torch.device(device)
        dt = A.DTYPES[cfg.kv_dtype]
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self._spill: Dict[int, Dict[str, torch.Tensor]] = {}  # host pages
        # device-side per-stream page tables, built once per residency
        # epoch (invalidated on admit/evict/restore/retire/page-evict)
        self._dev_tables: Dict[int, torch.Tensor] = {}
        # spill/restore traffic goes through the state plane's async
        # transfer engine so residency churn is charged the paper's
        # async-stream protocol latency
        self.engine = engine or AsyncTransferEngine(n_layers=cfg.n_layers)
        # directional byte counters: spill = out, restore = in
        self.transfer_bytes_in = 0
        self.transfer_bytes_out = 0

    @property
    def transfer_bytes(self) -> int:
        return self.transfer_bytes_in + self.transfer_bytes_out

    # ---- ledger views ------------------------------------------------------
    @property
    def n_pages(self) -> int:
        return self.ledger.n_pages

    @property
    def pages_per_stream(self) -> int:
        return self.ledger.pages_per_stream

    @property
    def free_pages(self) -> int:
        return self.ledger.free_pages

    @property
    def chunks(self) -> Dict[int, int]:
        """Per-stream chunk counts (resident and spilled streams)."""
        return self.ledger.chunks

    def can_admit(self) -> bool:
        return self.ledger.can_admit()

    def resident(self, sid: int) -> bool:
        return self.ledger.resident(sid)

    def resident_sids(self) -> List[int]:
        return self.ledger.resident_sids()

    def spilled(self, sid: int) -> bool:
        return sid in self._spill

    # ---- device writes -----------------------------------------------------
    def _write(self, pages: np.ndarray, nk: torch.Tensor,
               nv: torch.Tensor) -> None:
        pages = [int(p) for p in np.asarray(pages).reshape(-1)]
        kvcache.pool_write_pages(self.k, nk.to(self.device), pages)
        kvcache.pool_write_pages(self.v, nv.to(self.device), pages)

    def _sink_kv(self, cond: torch.Tensor):
        return A.cond_kv(self.cfg, self.params, cond.to(self.device))

    def table_rows(self, sid: int) -> np.ndarray:
        """Physical page rows of ``sid``'s table with holes (-1:
        individually evicted ring pages) mapped to the stream's own
        sink page — a valid, fully-masked stand-in: the visibility
        masks never attend to a dropped chunk's tokens."""
        t = self.ledger.tables[sid]
        return np.where(t < 0, t[0], t)

    def device_table(self, sid: int) -> torch.Tensor:
        """This stream's page table as a device int32 [1 + W] tensor,
        cached for the residency epoch."""
        t = self._dev_tables.get(sid)
        if t is None:
            t = torch.as_tensor(self.table_rows(sid), dtype=torch.int32) \
                .to(self.device)
            self._dev_tables[sid] = t
        return t

    def tables_for(self, sids: Sequence[int]) -> torch.Tensor:
        """Stacked [b, 1 + W] block table of a sub-batch (device)."""
        return torch.stack([self.device_table(sid) for sid in sids])

    def gather(self, sids: Sequence[int],
               n_ring: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Contiguous [L, b, COND + n_ring*tc, Hkv, Dh] context for a
        sub-batch, assembled through the page tables (the ``gather``
        context backend — the paged backend never materializes this)."""
        tables = self.tables_for(sids)
        k = kvcache.gather_pages(self.k, tables, A.COND_TOKENS, self._tc,
                                 n_ring)
        v = kvcache.gather_pages(self.v, tables, A.COND_TOKENS, self._tc,
                                 n_ring)
        return k, v

    # ---- residency lifecycle -----------------------------------------------
    def admit(self, sid: int, cond: torch.Tensor) -> bool:
        """Admit one stream: write its cond (sink) KV into a fresh page
        set.  Returns False when the pool is full — the stream is parked
        host-side and the caller must evict-and-``restore`` or defer."""
        sk, sv = self._sink_kv(cond)
        if self.can_admit():
            table = self.ledger.take(sid)
            self._dev_tables.pop(sid, None)
            self._write(table[:1], sk, sv)
            return True
        shape = (self.cfg.n_layers, self.pages_per_stream,
                 self.page_tokens) + tuple(self.k.shape[3:])
        pages = torch.zeros(shape, dtype=self.k.dtype)
        pages_v = torch.zeros_like(pages)
        pages[:, 0, :A.COND_TOKENS] = sk[:, 0].cpu()
        pages_v[:, 0, :A.COND_TOKENS] = sv[:, 0].cpu()
        self._spill[sid] = {"k": pages, "v": pages_v}
        self.ledger.spilled.add(sid)
        self.ledger.chunks[sid] = 0
        return False

    def _charge_transfer(self, n_bytes: int, direction: str) -> None:
        """Record one spill/restore on the async transfer engine;
        ``direction`` is ``"out"`` (spill) or ``"in"`` (restore)."""
        if direction == "out":
            self.transfer_bytes_out += n_bytes
        else:
            self.transfer_bytes_in += n_bytes
        self.engine.transfer(time.perf_counter(), n_bytes,
                             cross_node=False)

    def evict(self, sid: int) -> int:
        """Spill a resident stream's pages to host memory and free them.
        Returns the number of pages released.  A partially-degraded
        stream spills with its hole slices zeroed."""
        table = self.ledger.tables[sid]
        holes = np.flatnonzero(np.asarray(table) < 0)
        rows = torch.as_tensor(self.table_rows(sid), dtype=torch.long,
                               device=self.device)
        # host copies BEFORE the pages are reused
        spill_k = self.k[:, rows].cpu()
        spill_v = self.v[:, rows].cpu()
        if holes.size:
            spill_k[:, holes] = 0
            spill_v[:, holes] = 0
        self._spill[sid] = {"k": spill_k, "v": spill_v}
        self.ledger.drop(sid, spill=True)
        self._dev_tables.pop(sid, None)
        self._charge_transfer(_nbytes(spill_k) + _nbytes(spill_v), "out")
        return self.pages_per_stream

    def evict_page(self, sid: int) -> bool:
        """Free ONE ring page of ``sid`` (the degradation ladder's first
        rung).  The page's KV is discarded — no host spill and NO
        transfer charge.  False when the stream is at its floor."""
        if self.ledger.evict_page(sid) is None:
            return False
        self._dev_tables.pop(sid, None)
        return True

    def has_evictable_page(self, sid: int) -> bool:
        return self.ledger.page_eviction_entry(sid) is not None

    def effective_window(self, sid: int, window: int) -> int:
        """Chunks of context actually visible to ``sid``'s next chunk:
        the fidelity window clipped by fill and ring size, minus
        visible chunks lost to page-granular eviction."""
        n = self.ledger.chunks.get(sid, 0)
        w_vis = min(int(window), n, self._w)
        dropped = self.ledger.dropped.get(sid, ())
        lost = sum(1 for c in dropped if n - w_vis <= c < n)
        return w_vis - lost

    def restore(self, sid: int, *, charge: bool = True) -> bool:
        """Bring a spilled stream back resident (bit-exact: its pages
        are written back verbatim).  False when the pool is full."""
        if not self.can_admit():
            return False
        sp = self._spill.pop(sid)
        table = self.ledger.take(sid, chunks=self.ledger.chunks[sid])
        self._dev_tables.pop(sid, None)
        self._write(table, sp["k"], sp["v"])
        if charge:
            self._charge_transfer(_nbytes(sp["k"]) + _nbytes(sp["v"]), "in")
        return True

    def export_spill(self, sid: int, *,
                     to_host: bool = True) -> Tuple[Dict[str, Any], int]:
        """Detach one stream's KV as pages + chunk count (the migration
        export half): a resident stream's pages are copied out and
        freed — to host memory, or with ``to_host=False`` as tensors on
        this pool's device — and a spilled stream hands over its
        existing spill buffer verbatim.  No transfer is charged: the
        caller owns the movement (``import_spill`` / ``import_pages`` on
        the destination pool is where it is accounted)."""
        n_chunks = self.ledger.chunks.get(sid, 0)
        if self.ledger.resident(sid):
            holes = np.flatnonzero(np.asarray(self.ledger.tables[sid]) < 0)
            rows = torch.as_tensor(self.table_rows(sid), dtype=torch.long,
                                   device=self.device)
            pages = {"k": self.k[:, rows], "v": self.v[:, rows]}
            if to_host:
                pages = {n: t.cpu() for n, t in pages.items()}
                if holes.size:
                    for t in pages.values():
                        t[:, holes] = 0
            # on the device, hole rows hold the sink page: garbage, but
            # the dropped-chunk masks travel with the stream and keep
            # those slices invisible on the destination lane
            self.ledger.drop(sid, spill=False)
        else:
            pages = self._spill.pop(sid)
            self.ledger.spilled.discard(sid)
            self.ledger.chunks.pop(sid, None)
        self._dev_tables.pop(sid, None)
        return pages, n_chunks

    def import_spill(self, sid: int, pages: Dict[str, Any],
                     n_chunks: int) -> None:
        """Adopt an exported stream host-side (spilled, re-admittable):
        the inverse of ``export_spill``.  The stream becomes resident
        through the normal ``restore`` path, so the round trip is
        bit-exact."""
        assert not self.ledger.resident(sid) and sid not in self._spill, \
            f"stream {sid} already present in destination pool"
        self._spill[sid] = pages
        self.ledger.spilled.add(sid)
        self.ledger.chunks[sid] = n_chunks

    def import_pages(self, sid: int, pages: Dict[str, Any],
                     n_chunks: int) -> None:
        """Adopt an exported page set directly into a fresh page table
        (immediately resident, no host-side parking).  The caller checks
        ``can_admit`` first."""
        assert not self.ledger.resident(sid) and sid not in self._spill, \
            f"stream {sid} already present in destination pool"
        assert self.can_admit(), \
            "direct import requires space (caller checks can_admit)"
        table = self.ledger.take(sid, chunks=n_chunks)
        self._dev_tables.pop(sid, None)
        self._write(table, pages["k"], pages["v"])

    def release(self, sid: int) -> None:
        """Retire a stream entirely (resident or spilled).  Idempotent."""
        self.ledger.drop(sid, spill=False)
        self._spill.pop(sid, None)
        self._dev_tables.pop(sid, None)

    def append(self, sids: Sequence[int], new_kv: Dict[str, torch.Tensor],
               quant: str) -> None:
        """Ring-write one finished chunk of KV per stream into its page
        and advance its chunk count (``new_kv`` rows align with
        ``sids``).  An fp8 fidelity rounds the KV through
        ``float8_e4m3fn`` (reference overflow semantics) before it lands
        in the pool's dtype."""
        if quant == "fp8":
            new_kv = {k: kvcache.to_fp8_e4m3(v) for k, v in new_kv.items()}
        for sid in sids:
            # an append into a hole heals the table (free page or a
            # stolen sibling): the cached device table goes stale
            if np.any(np.asarray(self.ledger.tables[sid]) < 0):
                self._dev_tables.pop(sid, None)
        pages = np.asarray([self.ledger.append_page(sid) for sid in sids])
        self._write(pages, new_kv["k"], new_kv["v"])
        for sid in sids:
            self.ledger.chunks[sid] += 1
            self.ledger.prune_dropped(sid)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class SPLink:
    """One stream's active elastic-SP2 borrow (SS4.3): the donor lane id
    and the donor lane's KV pool.  Two serving modes:

    * ``"solo"`` — the donor page set carries the stream's UPPER half KV
      heads (Ulysses head partition, App. C.4) and the home lane runs
      the head-split step ``ardit.denoise_step_paged_sp`` reading BOTH
      pools, dispatched solo with the donor's step slot reserved.
    * ``"batch"`` — the donor page set carries FULL heads and the stream
      is served ON the donor lane as an ordinary extra row of the
      donor's own micro-batch, bit-identical to the SP1 step.

    Either way the home pool stays the full-head system of record
    (batch mode ships each completed chunk's KV home), so releasing a
    link frees the donor pages and nothing moves back."""
    donor: int
    pool: KVPool
    mode: str = "solo"


@dataclasses.dataclass
class SPGuest:
    """Donor-side view of one batch-axis SP borrow: the borrowed stream
    runs HERE as a guest batch row over full-head donor pages, while
    ``pool`` (the HOME lane's pool) stays the system of record — each
    completed guest chunk's full-head KV is appended there too."""
    home: int
    pool: KVPool


@dataclasses.dataclass
class InflightChunk:
    """One stream's chunk mid-generation (step-granular state)."""
    x: torch.Tensor                   # [1, T_c, LATENT_CH] latents
    fidelity: FidelityConfig
    step: int = 0                     # denoise steps completed
    started: float = 0.0              # session clock at chunk start
    active_s: float = 0.0             # wall spent in steps (not held out)

    @property
    def phase(self) -> str:
        """'denoise' while steps remain, then one 'clean' KV pass."""
        return "denoise" if self.step < self.fidelity.steps else "clean"


class BatchedChunkExecutor(ChunkExecutor):
    """Multi-stream executor over a shared paged KV pool on ``device``.

    ``run_step`` advances one sub-batch by a single denoise step (or the
    clean-context pass that finishes a chunk), so the scheduler can
    recompose the batch between any two steps.

    ``context_backend`` selects how a sub-batch sees its cached KV:

    * ``"paged"`` (default) — page-table-native: the step receives the
      pool itself plus per-stream block tables and page-coordinate
      visibility masks (``ardit.denoise_step_paged`` ->
      ``attention.paged_mha`` -> ``kernels/paged_attention``).
    * ``"gather"`` — the contiguous context gathered through the tables
      once per chunk boundary (``ardit.denoise_step`` ->
      ``attention.mha``).  The two backends agree numerically.

    ``device`` defaults to the card; ``device="cpu"`` runs the plain
    PyTorch version of every kernel.
    """

    def __init__(self, cfg: Optional[ModelConfig] = None,
                 params: Optional[Any] = None, seed: int = 0,
                 max_streams: int = 16,
                 context_backend: str = "paged",
                 engine: Optional[AsyncTransferEngine] = None,
                 device: Any = "cuda",
                 page_evict: bool = False):
        if context_backend not in ("gather", "paged"):
            raise ValueError(f"context_backend {context_backend!r}: "
                             "'paged' or 'gather'")
        super().__init__(cfg=cfg, params=params, seed=seed, device=device)
        self.context_backend = context_backend
        # partial-window residency: under pool pressure, evict single
        # ring pages from high-credit residents before whole-stream
        # spill.  Opt-in: page eviction DISCARDS the page's KV.
        self.page_evict = page_evict
        self.pool = KVPool(self.cfg, self.params, max_streams,
                           engine=engine, device=self.device)
        self.inflight: Dict[int, InflightChunk] = {}
        self.chunks: Dict[int, List[torch.Tensor]] = {}
        self.fidelity_log: Dict[int, List[str]] = {}
        # noise-sequence counter per stream: tracks generated chunks
        # but RESETS on a prompt switch, while ``chunks`` keeps the full
        # playout history
        self.chunk_seq: Dict[int, int] = {}
        # active elastic-SP2 borrows of this lane's streams: sid ->
        # SPLink (set / cleared by the LanePool apply layer); run_step
        # takes the head-split path for a solo stream with a link
        self.sp_links: Dict[int, SPLink] = {}
        # sids whose pages in THIS pool are another lane's live SP
        # mirror (the stream is inflight on its HOME lane, so the
        # inflight filter alone would not protect them here)
        self.sp_mirrors: set = set()
        # batch-axis SP borrows served ON this lane: sid -> SPGuest
        self.sp_guests: Dict[int, SPGuest] = {}
        self.step_ema: Dict[str, float] = {}      # per-step wall seconds
        self.evictions = 0
        self.restores = 0
        self.deferrals = 0      # residency requests that had to wait
        self.page_evictions = 0   # single ring pages freed (ladder rung 1)
        self.dispatch_count = 0   # batched step launches issued
        # per-stream effective-window history: one entry per completed
        # chunk = chunks of context its generation actually attended to
        self.effective_window_log: Dict[int, List[int]] = {}
        # modeled async-stream transfer wait not yet charged to a
        # stream's measured chunk latency (spill/restore protocol cost)
        self._pending_wait: Dict[int, float] = {}
        self.transfer_wait_s = 0.0
        # per-sub-batch tables + masks are constant across the steps of
        # a chunk, so they are cached per (group, fill, fidelity) chunk
        # boundary; staging vectors repeat per fidelity mix
        self._boundary_cache: Dict[tuple, Dict[str, Any]] = {}
        self._staging_cache: Dict[tuple, tuple] = {}

    # ---- stream lifecycle --------------------------------------------------
    def admit(self, sid: int, seed: int = 0,
              streams: Optional[Dict[int, Stream]] = None,
              protect: Sequence[int] = ()) -> bool:
        """Admit a stream.  On a full pool, evict the highest-credit
        evictable resident first (``streams`` supplies the credit view);
        without a credit view or an evictable victim the stream is
        parked host-side (defer) and False is returned — it joins later
        via ``ensure_resident``.  Never raises on exhaustion."""
        cond = cond_noise(seed, self.cfg.d_model)
        self.chunks[sid] = []
        self.fidelity_log[sid] = []
        self.effective_window_log[sid] = []
        self.chunk_seq[sid] = 0
        # boundary keys are (sids, fills, fid) and would collide with a
        # previous stream of the same id at the same fill — drop them
        self._boundary_cache.clear()
        mark = len(self.pool.engine.log)
        while not self.pool.can_admit():
            if not self._evict_one(streams, protect=set(protect) | {sid}):
                break
        ok = self.pool.admit(sid, cond)      # parks host-side when full
        if not ok:
            self.deferrals += 1
        self._charge_transfer_wait(sid, mark)
        return ok

    def _charge_transfer_wait(self, sid: int, log_mark: int) -> None:
        """Charge the dispatcher wait of any spill/restore transfers
        issued since ``log_mark`` to ``sid``'s next completed chunk."""
        new = self.pool.engine.log[log_mark:]
        if new:
            w = sum(t.residual_wait for t in new)
            self._pending_wait[sid] = self._pending_wait.get(sid, 0.0) + w
            self.transfer_wait_s += w

    def _evict_one(self, streams: Optional[Dict[int, Stream]],
                   protect: set) -> bool:
        """Free pages: credit-aware victim selection over the evictable
        residents.  In-flight streams are protected (their chunk is
        mid-denoise and rejoins the batch at the next step); so are live
        SP mirrors (``sp_mirrors``: the owning stream is inflight on its
        HOME lane, invisible to this lane's inflight set), streams with
        a live SP link and batch-axis guests — a borrow's pages on BOTH
        lanes must survive it."""
        if streams is None:
            return False
        victims = [s for s in self.pool.resident_sids()
                   if s not in self.inflight and s not in self.sp_mirrors
                   and s not in self.sp_links and s not in self.sp_guests]
        if self.page_evict:
            # degradation ladder rung 1: free ONE ring page from the
            # highest-credit resident that still has one to give
            victim = queues.pick_page_eviction(
                victims, streams, protect=protect,
                has_evictable=self.pool.has_evictable_page)
            if victim is not None:
                self.pool.evict_page(victim)
                self.page_evictions += 1
                self._boundary_cache.clear()
                return True
        # rung 2: whole-stream spill (host round trip, bit-exact)
        victim = queues.pick_eviction(victims, streams, protect=protect)
        if victim is None:
            return False
        self.pool.evict(victim)
        self.evictions += 1
        self._boundary_cache.clear()
        return True

    def ensure_resident(self, sid: int,
                        streams: Optional[Dict[int, Stream]] = None,
                        protect: Sequence[int] = ()) -> bool:
        """Re-admit a spilled stream (spilled streams rejoin at chunk
        boundaries, bit-exactly).  False means the stream must wait
        this tick (defer)."""
        if self.pool.resident(sid):
            return True
        assert self.pool.spilled(sid), f"stream {sid} was never admitted"
        mark = len(self.pool.engine.log)
        while not self.pool.can_admit():
            if not self._evict_one(streams, protect=set(protect) | {sid}):
                self.deferrals += 1
                return False
        ok = self.pool.restore(sid)
        assert ok
        self.restores += 1
        self._charge_transfer_wait(sid, mark)
        # the restored stream owns DIFFERENT physical pages now: any
        # cached boundary naming its old block table is stale
        self._boundary_cache.clear()
        return True

    def abort_chunk(self, sid: int) -> None:
        """Drop an in-flight chunk at a step boundary (prompt switch).
        Pool state needs no rollback — KV is only appended at the clean
        pass."""
        self.inflight.pop(sid, None)

    def retire(self, sid: int, drop_history: bool = False) -> None:
        """Retire a stream: free its pages and per-stream counters.
        ``drop_history=True`` also drops the generated-chunk and
        fidelity history (the warm-up calibration stream, sid -1)."""
        assert sid not in self.sp_links, \
            f"stream {sid} retired with a live SP link (release first)"
        self.pool.release(sid)
        self.inflight.pop(sid, None)
        self._pending_wait.pop(sid, None)
        self.chunk_seq.pop(sid, None)
        if drop_history:
            self.chunks.pop(sid, None)
            self.fidelity_log.pop(sid, None)
            self.effective_window_log.pop(sid, None)
        self._boundary_cache.clear()

    def reset_condition(self, sid: int, seed: int) -> bool:
        """Prompt switch (SS3.3): re-encode a FRESH conditioning and
        rewrite the stream's sink page through ``KVPool.admit`` (release
        + re-admit), discarding the old prompt's ring KV and resetting
        the noise sequence.  Returns False when the pool is full and the
        stream parked host-side (it rejoins via ``ensure_resident``)."""
        self.inflight.pop(sid, None)
        cond = cond_noise(seed, self.cfg.d_model)
        mark = len(self.pool.engine.log)
        self.pool.release(sid)
        ok = self.pool.admit(sid, cond)
        if not ok:
            self.deferrals += 1
        self._charge_transfer_wait(sid, mark)
        self.chunk_seq[sid] = 0
        self._boundary_cache.clear()
        return ok

    def export_stream(self, sid: int, *,
                      to_host: bool = True) -> Dict[str, Any]:
        """Detach a stream for cross-lane migration (KV pages, counters,
        generated chunks).  Only legal at a chunk boundary with no live
        SP link — exactly the streams ``rehoming.plan_rehoming`` deems
        movable.  No transfer is charged here; ``import_stream`` on the
        destination accounts the src->dst move."""
        assert sid not in self.inflight, f"stream {sid} is mid-chunk"
        assert sid not in self.sp_links, f"stream {sid} has a live SP link"
        dropped = sorted(self.pool.ledger.dropped.get(sid, ()))
        pages, n_chunks = self.pool.export_spill(sid, to_host=to_host)
        self._boundary_cache.clear()
        return {"pages": pages, "chunk_count": n_chunks,
                "chunks": self.chunks.pop(sid),
                "fidelity_log": self.fidelity_log.pop(sid),
                "chunk_seq": self.chunk_seq.pop(sid, 0),
                "pending_wait": self._pending_wait.pop(sid, 0.0),
                "dropped": dropped,
                "effective_window_log":
                    self.effective_window_log.pop(sid, [])}

    def import_stream(self, sid: int, state: Dict[str, Any], *,
                      cross_node: bool = False,
                      direct: bool = False) -> None:
        """Adopt an exported stream (the re-homing apply half): ONE
        src->dst transfer is charged on the shared engine (cross-node
        bandwidth when the lanes' nodes differ) and the dispatcher wait
        rides on the stream's next completed chunk.  ``direct=True``
        writes ``state["pages"]`` straight into a fresh page table
        (immediately resident); otherwise the KV arrives host-side and
        the stream becomes resident through the normal restore path,
        bit-exactly."""
        self.chunks[sid] = state["chunks"]
        self.fidelity_log[sid] = state["fidelity_log"]
        self.chunk_seq[sid] = state["chunk_seq"]
        self.effective_window_log[sid] = \
            list(state.get("effective_window_log", []))
        if state.get("dropped"):
            # degradation history travels with the stream: the lost
            # chunks' slices stay masked here too
            self.pool.ledger.dropped[sid] = set(state["dropped"])
        if direct:
            self.pool.import_pages(sid, state["pages"],
                                   state["chunk_count"])
        else:
            self.pool.import_spill(sid, state["pages"],
                                   state["chunk_count"])
        n_bytes = _nbytes(state["pages"]["k"]) + _nbytes(state["pages"]["v"])
        self.pool.transfer_bytes_in += n_bytes
        t = self.pool.engine.transfer(time.perf_counter(), n_bytes,
                                      cross_node=cross_node)
        w = state["pending_wait"] + t.residual_wait
        self._pending_wait[sid] = self._pending_wait.get(sid, 0.0) + w
        self.transfer_wait_s += t.residual_wait
        self._boundary_cache.clear()

    def begin_chunk(self, sid: int, fidelity: FidelityConfig,
                    now: float) -> None:
        """Start a chunk at a step boundary (noise seeded per stream and
        chunk, see ``chunk_noise``)."""
        if fidelity.cache != "off":
            raise NotImplementedError(
                "the step cache waits for its slice (ROADMAP: port queue)")
        noise = chunk_noise(self.chunk_seq[sid], sid,
                            A.chunk_tokens(self.cfg)).to(self.device)
        self.inflight[sid] = InflightChunk(x=noise, fidelity=fidelity,
                                           started=now)

    def steps_left(self, sid: int) -> int:
        """Remaining forwards for the in-flight chunk (incl. clean pass)."""
        f = self.inflight[sid]
        return f.fidelity.steps + 1 - f.step

    # ---- the batched step --------------------------------------------------
    def _boundary(self, sids: Sequence[int], chunk_idx: np.ndarray,
                  fids: Sequence[FidelityConfig],
                  sp: Optional[SPLink] = None) -> Dict[str, Any]:
        """Per-chunk-boundary state of a sub-batch (constant across the
        chunk's steps): positions, denoise/clean visibility, and the
        backend's context handle — a gathered [L, b, extent, ...] copy
        for ``gather``, or the block tables + page-coordinate masks the
        paged step reads the pool through (both sliced to the group's
        resident extent, so compute scales with fill).
        ``fids`` is per-row: a fused group hands each row the
        window/sparsity mask its own fidelity dictates.  An active SP2
        link adds the donor pool's block table — the head-split step
        reads its upper half heads through it."""
        key = (tuple(sids), tuple(chunk_idx.tolist()),
               tuple(f.key for f in fids),
               sp.donor if sp is not None else None)
        bnd = self._boundary_cache.get(key)
        if bnd is not None:
            return bnd
        tc = A.chunk_tokens(self.cfg)
        w_max = self.cfg.ardit_window_chunks
        n_ring = int(min(chunk_idx.max(initial=0), w_max))
        extent = A.COND_TOKENS + n_ring * tc
        # sparsity applies to denoise steps only; the clean-context pass
        # sees the full fidelity window
        windows = np.asarray([f.window for f in fids], np.int64)
        dn = A.batched_context_mask_multi(
            self.cfg, chunk_idx, windows,
            np.asarray([f.sparsity for f in fids]))[:, :extent]
        cl = A.batched_context_mask_multi(
            self.cfg, chunk_idx, windows,
            np.zeros(len(fids)))[:, :extent]
        self._mask_dropped(sids, chunk_idx, dn, cl)
        dev = self.device
        bnd = {"q_offset": torch.as_tensor(A.COND_TOKENS + chunk_idx * tc,
                                           dtype=torch.int32).to(dev)}
        if self.context_backend == "paged":
            # dn all-true (homogeneous fill, full window, no sparsity)
            # drops BOTH masks — each page's static valid prefix is
            # visible (cl is a superset of dn); an unsparsified
            # fidelity's clean mask IS the denoise mask — cl=None then
            # means "reuse dn"
            bnd["tables"] = self.pool.tables_for(sids)[:, :1 + n_ring]
            if sp is not None:
                bnd["tables_d"] = sp.pool.tables_for(sids)[:, :1 + n_ring]

            def pages(mask):
                return torch.as_tensor(kvcache.mask_to_pages(
                    mask, n_ring, A.COND_TOKENS, tc,
                    self.pool.page_tokens)).to(dev)

            if dn.all():
                bnd["dn"] = bnd["cl"] = None
            else:
                bnd["dn"] = pages(dn)
                bnd["cl"] = None if np.array_equal(dn, cl) else pages(cl)
        else:
            # all-true masks (homogeneous fill, no sparsity, full window)
            # are dropped so the step attends unmasked — through the
            # flash-attention kernel on the card
            bnd["ctx_k"], bnd["ctx_v"] = self.pool.gather(sids, n_ring)
            bnd["dn"] = None if dn.all() else torch.as_tensor(dn).to(dev)
            bnd["cl"] = None if cl.all() else torch.as_tensor(cl).to(dev)
        if len(self._boundary_cache) >= 8:
            self._boundary_cache.pop(next(iter(self._boundary_cache)))
        self._boundary_cache[key] = bnd
        return bnd

    def _mask_dropped(self, sids: Sequence[int], chunk_idx: np.ndarray,
                      dn: np.ndarray, cl: np.ndarray) -> None:
        """Zero the token slices of page-evicted chunks in BOTH
        visibility masks (their KV is gone).  Runs before the all-true
        fast-path check, forcing a degraded row onto the explicit-mask
        path — which keeps the sink-page stand-in rows unread."""
        tc = A.chunk_tokens(self.cfg)
        w_max = self.cfg.ardit_window_chunks
        for i, sid in enumerate(sids):
            dropped = self.pool.ledger.dropped.get(sid)
            if not dropped:
                continue
            n = int(chunk_idx[i])
            for c in dropped:
                if n - w_max <= c < n:
                    lo = A.COND_TOKENS + (c % w_max) * tc
                    dn[i, lo:lo + tc] = False
                    cl[i, lo:lo + tc] = False

    def _staging(self, fids: Sequence[FidelityConfig],
                 steps: Tuple[int, ...], denoising: Tuple[bool, ...]):
        """Cached per-step staging tensors (t, dt, is_denoise) on the
        device: they repeat for every chunk of a given fidelity mix.
        Per-row fidelity: each row walks its OWN sigma grid."""
        key = (tuple(f.key for f in fids), steps, denoising)
        st = self._staging_cache.get(key)
        if st is None:
            grids = [A.sigma_schedule(f.steps) for f in fids]
            t = [float(g[s]) if d else 0.0
                 for g, s, d in zip(grids, steps, denoising)]
            dt = [float(g[s] - g[s + 1]) if d else 0.0
                  for g, s, d in zip(grids, steps, denoising)]
            dev = self.device
            st = (torch.tensor(t, dtype=torch.float32).to(dev),
                  torch.tensor(dt, dtype=torch.float32).to(dev),
                  torch.tensor(denoising, dtype=torch.bool).to(dev))
            if len(self._staging_cache) >= 64:
                self._staging_cache.pop(next(iter(self._staging_cache)))
            self._staging_cache[key] = st
        return st

    def run_step(self, sids: Sequence[int],
                 sp_serve: bool = False) -> Tuple[List[int], float]:
        """Advance one sub-batch by one step — same-fidelity (split
        dispatch) or mixed-fidelity sharing one KV quantization dtype
        (fused dispatch): window, sparsity, sigma grid, and phase are
        per-row data.

        ``sp_serve=True`` marks a dispatch that RESERVED the linked
        stream's donor step slot (the scheduler's solo SP2 dispatch):
        only then does a solo linked stream take the head-split path.
        An unreserved dispatch — even of a lone linked stream — runs the
        SP1 step (the home pool holds full heads), so donor compute is
        never consumed twice, or zero times, in one round.

        Streams in their denoise phase take an Euler step; streams in
        their clean phase produce context KV, append it to the pool, and
        complete their chunk.  Both phases share ONE batched call.

        The host does NOT sync on intermediate steps; it syncs once per
        completed chunk, which also yields the measured whole-chunk
        wall latency fed into ``latency_ema``/``step_ema``.  Returns
        (completed sids, wall seconds of this call).
        """
        flights = [self.inflight[sid] for sid in sids]
        fids = [f.fidelity for f in flights]
        quant = fids[0].quant
        # steps/window/sparsity are per-row data, but the KV quantization
        # dtype belongs to the append path shared by the whole launch
        assert all(f.quant == quant for f in fids), \
            "sub-batch must share one KV quantization dtype"
        assert all(self.pool.resident(sid) for sid in sids), \
            "sub-batch contains a non-resident (spilled) stream"
        chunk_idx = np.asarray([self.pool.chunks[sid] for sid in sids],
                               np.int64)
        # a batch-mode link is served on the DONOR lane (the stream is a
        # guest row there); its home lane must never also step it, or
        # the two page sets would diverge
        assert not any(s in self.sp_links
                       and self.sp_links[s].mode == "batch"
                       for s in sids), \
            "batch-axis SP: linked stream must be served on its donor lane"
        sp = (self.sp_links.get(sids[0])
              if sp_serve and len(sids) == 1
              and self.context_backend == "paged" else None)
        if sp is not None and sp.mode != "solo":
            sp = None
        denoising = tuple(f.phase == "denoise" for f in flights)

        t0 = time.perf_counter()
        bnd = self._boundary(sids, chunk_idx, fids, sp=sp)
        x = (flights[0].x if len(flights) == 1
             else torch.cat([f.x for f in flights], dim=0))
        t, dt_sig, is_dn = self._staging(
            fids, tuple(f.step for f in flights), denoising)
        self.dispatch_count += 1
        if sp is not None:
            x_new, new_kv = A.denoise_step_paged_sp(
                self.cfg, self.params, x, t, dt_sig, self.pool.k,
                self.pool.v, sp.pool.k, sp.pool.v, bnd["tables"],
                bnd["tables_d"], bnd["dn"], bnd["cl"], bnd["q_offset"],
                is_dn)
        elif self.context_backend == "paged":
            # context stays IN the pool: the step reads the current
            # device buffers through the cached block tables (appends
            # only ever touch pages outside every in-flight window)
            x_new, new_kv = A.denoise_step_paged(
                self.cfg, self.params, x, t, dt_sig, self.pool.k,
                self.pool.v, bnd["tables"], bnd["dn"], bnd["cl"],
                bnd["q_offset"], is_dn)
        else:
            x_new, new_kv = A.denoise_step(
                self.cfg, self.params, x, t, dt_sig, bnd["ctx_k"],
                bnd["ctx_v"], bnd["q_offset"], bnd["dn"], bnd["cl"],
                is_dn)

        completed: List[int] = []
        clean_rows: List[int] = []
        for i, (sid, f) in enumerate(zip(sids, flights)):
            if denoising[i]:
                f.x = x_new[i:i + 1]
                f.step += 1
            else:
                clean_rows.append(i)
                completed.append(sid)
        if clean_rows:
            # effective window BEFORE the append advances chunk counts
            eff_w = {sids[i]: self.pool.effective_window(
                sids[i], fids[i].window) for i in clean_rows}
            rows = torch.as_tensor(clean_rows, device=self.device)
            self.pool.append([sids[i] for i in clean_rows],
                             {"k": new_kv["k"][:, rows],
                              "v": new_kv["v"][:, rows]}, quant)
            for i in clean_rows:
                row = {"k": new_kv["k"][:, i:i + 1],
                       "v": new_kv["v"][:, i:i + 1]}
                link = self.sp_links.get(sids[i])
                if link is not None:
                    # the donor's half-head mirror tracks the home pool:
                    # ring-write this chunk's upper half into the donor
                    # page set (solo mode: batch-linked streams never
                    # step on this lane)
                    self._append_sp_half(link, sids[i], row, quant)
                guest = self.sp_guests.get(sids[i])
                if guest is not None:
                    # batch-axis SP: the guest's home pool is the system
                    # of record — append the full-head chunk there too
                    guest.pool.append([sids[i]], row, quant)
            now_wall = None
            for i in clean_rows:
                sid = sids[i]
                fid = fids[i]
                f = self.inflight.pop(sid)
                self.chunks[sid].append(f.x)
                self.fidelity_log[sid].append(fid.key)
                self.effective_window_log.setdefault(sid, []).append(
                    eff_w[sid])
                self.chunk_seq[sid] = self.chunk_seq.get(sid, 0) + 1
                if now_wall is None:        # one sync per completion step
                    self._sync()
                    now_wall = time.perf_counter()
                # measured chunk wall -> timing priors, attributed to each
                # completing row's OWN fidelity key (``active_s`` accrued
                # per launch the row was live in); spill/restore waits
                # charged by the transfer engine ride on the chunk they
                # delayed
                lat = (f.active_s + (now_wall - t0)
                       + self._pending_wait.pop(sid, 0.0))
                self.latency_ema[fid.key] = (
                    EMA_DECAY * self.latency_ema.get(fid.key, lat)
                    + (1.0 - EMA_DECAY) * lat)
                step = lat / (fid.steps + 1)
                self.step_ema[fid.key] = (
                    EMA_DECAY * self.step_ema.get(fid.key, step)
                    + (1.0 - EMA_DECAY) * step)
        dt = time.perf_counter() - t0
        for sid in sids:
            f = self.inflight.get(sid)
            if f is not None:               # still mid-chunk
                f.active_s += dt
        return completed, dt

    def _append_sp_half(self, link: SPLink, sid: int,
                        new_kv: Dict[str, torch.Tensor], quant: str) -> None:
        """Ring-write one chunk's UPPER half KV heads into the donor
        pool's page set for ``sid`` (in lockstep with the home pool's
        full-head append)."""
        h2 = self.cfg.n_kv_heads // 2
        nk, nv = new_kv["k"][..., h2:, :], new_kv["v"][..., h2:, :]
        if quant == "fp8":
            nk, nv = kvcache.to_fp8_e4m3(nk), kvcache.to_fp8_e4m3(nv)
        page = [link.pool.ledger.append_page(sid)]
        kvcache.pool_write_pages_heads(link.pool.k, nk, page, h2)
        kvcache.pool_write_pages_heads(link.pool.v, nv, page, h2)
        link.pool.ledger.chunks[sid] += 1

    def remaining_estimate(self, sid: int) -> float:
        """R_u from the measured step EMA (not the offline profile)."""
        f = self.inflight.get(sid)
        if f is None:
            return 0.0
        per_step = self.step_ema.get(
            f.fidelity.key,
            self.latency_ema.get(f.fidelity.key, 0.0)
            / (f.fidelity.steps + 1))
        return self.steps_left(sid) * per_step


def serve_session_batched(n_streams: int = 4, chunks_per_stream: int = 4,
                          max_batch: int = 4,
                          realtime_budget: Optional[float] = None,
                          fidelity_policy=None,
                          pool_streams: Optional[int] = None,
                          context_backend: str = "paged",
                          verbose: bool = True,
                          device: Any = "cuda") -> List[ServedStream]:
    """Legacy batched entry point — a thin wrapper over
    ``serve.session.StreamingSession`` (all streams arrive at t=0,
    exact per-stream chunk counts).  ``pool_streams`` caps co-resident
    streams (oversubscription when < n_streams); defaults to
    n_streams + 1, i.e. everyone resident.  ``context_backend``:
    ``"paged"`` or ``"gather"``."""
    from repro_torch.serve.session import (SessionConfig, StreamingSession,
                                           uniform_specs)
    session = StreamingSession(
        SessionConfig(executor="batched", max_batch=max_batch,
                      pool_streams=pool_streams or (n_streams + 1),
                      context_backend=context_backend,
                      realtime_budget=realtime_budget, verbose=verbose,
                      device=device),
        fidelity_policy=fidelity_policy)
    for spec in uniform_specs(n_streams, chunks_per_stream):
        session.submit(spec)
    session.run()
    return session.served_streams()
