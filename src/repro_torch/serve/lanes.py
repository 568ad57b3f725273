"""Multi-lane serving: N lanes under one control plane, on one device.

A *lane* is one execution slot — one ``BatchedChunkExecutor`` with its
own paged ``KVPool`` — standing in for one Worker of the paper's
cluster (SS3.1).  All lanes of a ``LanePool`` live on the one
``device`` it is given (default the card): each has its own pool, and
the lanes share one params replica and one transfer engine (one metrics
surface).  ``LanePool`` is the **apply layer** for the cross-worker
decisions ``core.control_plane.ControlPlane.tick`` emits:

* ``rehoming.Migration`` -> :meth:`migrate`: a real cross-lane KV move.
  The source detaches the stream's pages host-side
  (``KVPool.export_spill``, bit-exact) and the destination adopts them
  through its normal restore path.  ONE src->dst transfer is charged on
  the shared ``state_plane.AsyncTransferEngine`` (cross-node bandwidth
  when the lanes' nodes differ) and the bytes are attributed
  directionally: source ``transfer_bytes_out``, destination
  ``transfer_bytes_in``.
* ``elastic_sp.SPDecision`` -> :meth:`sp_expand` / :meth:`sp_release`,
  in one of two modes (``SPLink.mode``):

  - **solo** (``sp_mode="solo"``, the default): expand copies the
    stream's UPPER half KV heads into a page set of the donor lane's
    pool (the App. C.4 head-partition transfer: half the stream's
    bytes) and the executor serves it with the Ulysses head-split
    ``ardit.denoise_step_paged_sp``
    — the home shard reads heads [0, H/2) from the home pool and the
    donor shard heads [H/2, H) from the donor pool, each through a
    head-range view of its pool read in place by the paged kernel —
    dispatched solo, so the donor's step slot is genuinely occupied.
    The home pool stays the full-head system of record; release just
    frees the donor pages.
  - **batch** (``sp_mode="batch"``): expand copies FULL-head pages into
    the donor pool and the borrowed stream joins the *batch axis* of
    the donor's own sub-batch — co-served with the donor's streams in
    the donor's ordinary ``denoise_step_paged`` call, consuming no solo
    dispatch slot.  Each completed chunk's KV is appended to the home
    pool too, which therefore stays the system of record: release frees
    the donor pages and moves nothing back.

  Both modes are bit-identical to the SP1 step wherever the
  computation per head does not depend on the number of heads or rows
  in a call (the plain versions on the CPU; on the card, see
  ``PERF.md``).

The reference's ``prejit_sp`` warms JAX's compile caches for the
head-split step; PyTorch runs eagerly and the kernels are instantiated
per head dim, not per head count, so there is nothing to warm and it
has no counterpart here.  Lanes on DIFFERENT devices wait for their
slice (ROADMAP): the direct device-to-device migration, the timed
``_measured_put`` and batch-axis SP forced by a device difference raise
``NotImplementedError``, and so do co-served model bundles (in the
session).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core.state_plane import AsyncTransferEngine
from repro_torch.core.types import Stream
from repro_torch.models import kvcache
from repro_torch.serve.batcher import (BatchedChunkExecutor, KVPool, SPGuest,
                                       SPLink, _nbytes)

_CROSS_DEVICE = ("lanes on different devices (direct device-to-device "
                 "migration, measured puts, device-forced batch SP) wait "
                 "for their slice (ROADMAP: port queue)")


class LanePool:
    """One ``BatchedChunkExecutor`` per lane, all on ``device``, + the
    decision apply layer.

    ``lane_of`` maps every admitted stream to its current home lane;
    migrations move it.  Counters (``n_migrations``, ``n_sp_expands``,
    ``n_sp_releases``) record decisions actually *applied* — the
    control plane separately counts decisions *planned*.
    """

    def __init__(self, n_lanes: int = 1, cfg: Any = None, params: Any = None,
                 seed: int = 0, max_streams: int = 16,
                 context_backend: str = "paged",
                 engine: Optional[AsyncTransferEngine] = None,
                 sp_mode: str = "solo", page_evict: bool = False,
                 device: Any = "cuda"):
        if n_lanes < 1:
            raise ValueError(f"n_lanes {n_lanes}: at least 1")
        if sp_mode not in ("solo", "batch"):
            raise ValueError(f"sp_mode {sp_mode!r}: 'solo' or 'batch'")
        first = BatchedChunkExecutor(cfg=cfg, params=params, seed=seed,
                                     max_streams=max_streams,
                                     context_backend=context_backend,
                                     engine=engine, device=device,
                                     page_evict=page_evict)
        executors = [first] + [
            BatchedChunkExecutor(cfg=first.cfg, params=first.params,
                                 max_streams=max_streams,
                                 context_backend=context_backend,
                                 engine=first.pool.engine, device=device,
                                 page_evict=page_evict)
            for _ in range(1, n_lanes)]
        self._init(executors, first.pool.engine, sp_mode)

    @classmethod
    def wrap(cls, executor: Any) -> "LanePool":
        """Single-lane pool around an existing executor (the session's
        ``executor=`` injection; also adapts the sequential whole-chunk
        executor, which has no page pool)."""
        self = cls.__new__(cls)
        pool = getattr(executor, "pool", None)
        self._init([executor],
                   pool.engine if pool is not None else executor.engine,
                   "solo")
        return self

    def _init(self, executors: List[Any], engine: AsyncTransferEngine,
              sp_mode: str):
        self.executors = executors
        self.engine = engine
        self.sp_mode = sp_mode
        self.lane_of: Dict[int, int] = {}
        self.n_migrations = 0
        self.n_sp_expands = 0
        self.n_sp_releases = 0

    # ---- views -------------------------------------------------------------
    @property
    def n_lanes(self) -> int:
        return len(self.executors)

    def ex(self, lane: int) -> Any:
        return self.executors[lane]

    @property
    def all_executors(self) -> List[Any]:
        return self.executors

    def executor_of(self, sid: int) -> Any:
        return self.executors[self.lane_of.get(sid, 0)]

    def chunks_of(self, sid: int) -> List[Any]:
        return self.executor_of(sid).chunks.get(sid, [])

    def serving_ex(self, sid: int) -> Any:
        """The executor currently SERVING ``sid``: its donor lane during
        a batch-axis SP borrow (the stream runs there as a guest batch
        row), its home lane otherwise."""
        link = self.sp_link(sid)
        if link is not None and link.mode == "batch":
            return self.executors[link.donor]
        return self.executor_of(sid)

    def is_inflight(self, sid: int) -> bool:
        return sid in self.serving_ex(sid).inflight

    def any_inflight(self) -> bool:
        return any(ex.inflight for ex in self.executors)

    def sp_link(self, sid: int) -> Optional[SPLink]:
        return getattr(self.executor_of(sid), "sp_links", {}).get(sid)

    def remaining_estimate(self, sid: int) -> float:
        return self.serving_ex(sid).remaining_estimate(sid)

    def latency_ema_get(self, key: str, default: float) -> float:
        """Measured chunk-latency EMA for a fidelity, averaged over the
        lanes that have observed it (the lanes share one device, so
        their EMAs estimate the same quantity)."""
        vals = [ex.latency_ema[key] for ex in self.executors
                if key in ex.latency_ema]
        return sum(vals) / len(vals) if vals else default

    # ---- stream lifecycle (routed to the home lane) ------------------------
    def admit(self, sid: int, lane: int, seed: int = 0,
              streams: Optional[Dict[int, Stream]] = None,
              protect: Sequence[int] = ()) -> bool:
        self.lane_of[sid] = lane
        return self.executors[lane].admit(sid, seed=seed, streams=streams,
                                          protect=protect)

    def ensure_resident(self, sid: int,
                        streams: Optional[Dict[int, Stream]] = None,
                        protect: Sequence[int] = ()) -> bool:
        return self.executor_of(sid).ensure_resident(sid, streams,
                                                     protect=protect)

    def abort_chunk(self, sid: int) -> None:
        self.serving_ex(sid).abort_chunk(sid)

    def reset_condition(self, sid: int, seed: int) -> bool:
        """Prompt switch: fresh cond encode + sink rewrite on the home
        lane.  Any live SP link must be released by the caller FIRST
        (the donor's pages mirror the old prompt's KV)."""
        ex = self.executor_of(sid)
        assert sid not in getattr(ex, "sp_links", {}), \
            f"stream {sid}: release the SP link before a prompt switch"
        return ex.reset_condition(sid, seed)

    def retire(self, sid: int) -> None:
        if self.sp_link(sid) is not None:
            self.sp_release(sid)
        self.executor_of(sid).retire(sid)

    def _same_device(self, a: Any, b: Any) -> None:
        if getattr(a, "device", None) != getattr(b, "device", None):
            raise NotImplementedError(_CROSS_DEVICE)

    # ---- decision apply: re-homing -----------------------------------------
    def migrate(self, sid: int, src: int, dst: int, *,
                cross_node: bool = False) -> bool:
        """Apply one ``rehoming.Migration`` as a real KV move through the
        host-spill path: the source detaches the stream's pages to host
        memory and the destination adopts them, landing them in its pool
        right away when there is room.  The stream's KV is bit-identical
        after the move.  Returns False (decision dropped) when the
        stream is mid-chunk, SP-linked or not on ``src`` — states the
        planner excludes, re-checked here because the executor, not the
        planner, owns ground truth."""
        if self.lane_of.get(sid) != src or src == dst:
            return False
        src_ex, dst_ex = self.executors[src], self.executors[dst]
        if sid in src_ex.inflight or sid in src_ex.sp_links:
            return False
        self._same_device(src_ex, dst_ex)
        state = src_ex.export_stream(sid, to_host=True)
        src_ex.pool.transfer_bytes_out += (_nbytes(state["pages"]["k"])
                                           + _nbytes(state["pages"]["v"]))
        dst_ex.import_stream(sid, state, cross_node=cross_node)
        self.lane_of[sid] = dst
        # land it in the destination pool right away when there is room
        # — the import already charged the src->dst move, so this
        # restore is free; under pressure the stream stays parked and
        # rejoins via ensure_resident (a genuine second movement,
        # charged then)
        if dst_ex.pool.can_admit():
            dst_ex.pool.restore(sid, charge=False)
            dst_ex._boundary_cache.clear()
        self.n_migrations += 1
        return True

    # ---- decision apply: elastic SP ----------------------------------------
    def _sp_mode_for(self, home_ex: Any, donor_ex: Any) -> str:
        """Serving mode of a new SP link: ``sp_mode`` (the reference
        also forces batch mode across devices, which wait here)."""
        self._same_device(home_ex, donor_ex)
        return self.sp_mode

    def sp_expand(self, sid: int, donor: int,
                  streams: Optional[Dict[int, Stream]] = None) -> bool:
        """Apply one SP expand: allocate a donor-pool page set, copy the
        stream's KV into it, and link the stream.  Solo mode copies the
        UPPER half heads (half the stream's bytes) and ``run_step``
        takes the head-split path; batch mode copies FULL heads and
        registers the stream as a donor-lane guest.  False when the
        apply is impossible right now (non-paged backend, stream not
        resident, donor pool unevictable) — the decision is dropped and
        the planner may re-issue it next tick."""
        home = self.lane_of.get(sid)
        if home is None or donor == home:
            return False
        ex = self.executors[home]
        if getattr(ex, "context_backend", None) != "paged":
            return False          # head split rides the paged step only
        if sid in ex.sp_links:
            return True
        if not ex.pool.resident(sid) and \
                not ex.ensure_resident(sid, streams, protect=[sid]):
            return False
        donor_ex = self.executors[donor]
        mode = self._sp_mode_for(ex, donor_ex)
        dpool: KVPool = donor_ex.pool
        while not dpool.can_admit():
            # the donor's own credit-aware eviction (protects its
            # in-flight streams AND any live SP mirrors)
            if not donor_ex._evict_one(streams, protect={sid}):
                return False
        dpool.ledger.take(sid, chunks=ex.pool.ledger.chunks[sid])
        dpool._dev_tables.pop(sid, None)
        if mode == "batch":
            n_bytes = self._copy_sp_full(ex.pool, dpool, sid)
            # the donor serves the guest with the HOME stream's noise
            # cursor and playout history: the chunk / fidelity lists are
            # SHARED objects (one system of record), the noise counter
            # is synced here and synced back on release
            donor_ex.sp_guests[sid] = SPGuest(home=home, pool=ex.pool)
            donor_ex.chunk_seq[sid] = ex.chunk_seq.get(sid, 0)
            donor_ex.chunks[sid] = ex.chunks[sid]
            donor_ex.fidelity_log[sid] = ex.fidelity_log[sid]
            # guest rows build their masks on the DONOR executor: any
            # page-evicted chunks must stay masked there too
            dropped = ex.pool.ledger.dropped.get(sid)
            if dropped:
                dpool.ledger.dropped[sid] = set(dropped)
        else:
            n_bytes = self._copy_sp_half(ex.pool, dpool, sid)
        t = self.engine.transfer(time.perf_counter(), n_bytes,
                                 cross_node=False)
        # the modeled dispatcher wait rides on the stream's next
        # completed chunk — which batch mode completes on the DONOR
        serving = donor_ex if mode == "batch" else ex
        serving._pending_wait[sid] = \
            serving._pending_wait.get(sid, 0.0) + t.residual_wait
        serving.transfer_wait_s += t.residual_wait
        # the mirror bytes LEAVE the home pool and LAND in the donor's
        ex.pool.transfer_bytes_out += n_bytes
        dpool.transfer_bytes_in += n_bytes
        ex.sp_links[sid] = SPLink(donor=donor, pool=dpool, mode=mode)
        donor_ex.sp_mirrors.add(sid)   # shield the mirror from eviction
        ex._boundary_cache.clear()
        donor_ex._boundary_cache.clear()
        self.n_sp_expands += 1
        return True

    def _copy_sp_half(self, home: KVPool, dpool: KVPool, sid: int) -> int:
        """Mirror the stream's upper half KV heads (all of its pages)
        into the donor pool's page set.  Verbatim copy — the SP2 step's
        donor shard then reads bit-identical values."""
        h2 = home.cfg.n_kv_heads // 2
        # holes (page-evicted ring entries) map to the sink page: the
        # mirrored rows are garbage there, but the dropped-chunk masks
        # keep them unread on both pools
        rows = torch.as_tensor(home.table_rows(sid), dtype=torch.long,
                               device=home.device)
        kh = home.k[:, rows][..., h2:, :]          # [L, pps, P, H/2, Dh]
        vh = home.v[:, rows][..., h2:, :]
        drows = dpool.ledger.tables[sid]
        kvcache.pool_write_pages_heads(dpool.k, kh, drows, h2)
        kvcache.pool_write_pages_heads(dpool.v, vh, drows, h2)
        return _nbytes(kh) + _nbytes(vh)

    def _copy_sp_full(self, home: KVPool, dpool: KVPool, sid: int) -> int:
        """Copy the stream's FULL-head pages into the donor pool's page
        set (batch-axis SP).  Verbatim copy — the donor then serves the
        stream with the ordinary SP1 step over bit-identical values."""
        rows = torch.as_tensor(home.table_rows(sid), dtype=torch.long,
                               device=home.device)
        k, v = home.k[:, rows], home.v[:, rows]
        dpool._write(dpool.ledger.tables[sid], k, v)
        return _nbytes(k) + _nbytes(v)

    def sp_release(self, sid: int) -> None:
        """Apply one SP release at a safe boundary: drop the link and
        free the donor pages.  The home pool kept full heads (batch mode
        appended each completed chunk there), so nothing moves back; a
        batch-mode release also clears the guest registration and
        carries the noise cursor home.  Idempotent."""
        ex = self.executor_of(sid)
        link = getattr(ex, "sp_links", {}).pop(sid, None)
        if link is None:
            return
        donor_ex = self.executors[link.donor]
        if link.mode == "batch":
            assert sid not in donor_ex.inflight, \
                "batch-axis SP release only at a chunk boundary"
            donor_ex.sp_guests.pop(sid, None)
            ex.chunk_seq[sid] = donor_ex.chunk_seq.pop(
                sid, ex.chunk_seq.get(sid, 0))
            donor_ex.chunks.pop(sid, None)        # shared list: home keeps it
            donor_ex.fidelity_log.pop(sid, None)
            w = donor_ex._pending_wait.pop(sid, 0.0)
            if w:
                ex._pending_wait[sid] = ex._pending_wait.get(sid, 0.0) + w
            donor_ex._boundary_cache.clear()
        link.pool.ledger.drop(sid, spill=False)
        link.pool._dev_tables.pop(sid, None)
        donor_ex.sp_mirrors.discard(sid)
        ex._boundary_cache.clear()
        self.n_sp_releases += 1
