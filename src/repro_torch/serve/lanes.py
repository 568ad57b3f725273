"""Multi-lane serving: N device-backed lanes under one control plane.

A *lane* is one execution slot — one ``BatchedChunkExecutor`` with its
own paged ``KVPool`` — standing in for one Worker of the paper's
cluster (SS3.1).  Lane i lives on ``devices[i % len(devices)]`` (the
reference's round-robin over ``jax.devices()``); without ``devices``
every lane lives on the one ``device`` (default the card).  Each lane
has its own pool and its own view of the one params replica (a copy on
its device), and the lanes share one transfer engine (one metrics
surface).  A move between lanes on different devices is a real
``.to(device)`` timed on the spot (:meth:`_measured_put`) and recorded
on the engine, whose measurements calibrate the model's ``bw_intra``.
``LanePool`` is the **apply layer** for the cross-worker decisions
``core.control_plane.ControlPlane.tick`` emits:

* ``rehoming.Migration`` -> :meth:`migrate`: a real cross-lane KV move.
  Lanes on one device detach the stream's pages host-side
  (``KVPool.export_spill``, bit-exact) and the destination adopts them
  through its normal restore path; lanes on different devices ship the
  resident page block device to device (measured) and land it resident
  at once (``KVPool.import_pages``).  Either way ONE src->dst transfer
  is charged on the shared ``state_plane.AsyncTransferEngine``
  (cross-node bandwidth when the lanes' nodes differ) and the bytes are
  attributed directionally: source ``transfer_bytes_out``, destination
  ``transfer_bytes_in``.
* ``elastic_sp.SPDecision`` -> :meth:`sp_expand` / :meth:`sp_release`,
  in one of two modes (``SPLink.mode``), chosen by ``sp_mode``, as in
  the reference: ``"auto"`` (the default) and ``"solo"`` take batch mode
  for lanes on different devices (the head-split step reads both pools
  in one call) and solo mode otherwise; ``"batch"`` takes batch mode for
  lanes on one device too.

  - **solo**: expand copies the
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
  - **batch**: expand copies FULL-head pages into the donor pool (a
    measured move when the donor is on another device) and the
    borrowed stream joins the *batch axis* of the donor's own sub-batch
    — co-served with the donor's streams in the donor's ordinary
    ``denoise_step_paged`` call, consuming no solo dispatch slot.  Each
    completed chunk's KV is shipped back to the home pool (``KVPool.
    _write`` lands it on the home device), which therefore stays the
    system of record: release frees the donor pages and moves nothing
    back.

  Both modes are bit-identical to the SP1 step wherever the
  computation per head does not depend on the number of heads or rows
  in a call (the plain versions on the CPU; on the card, see
  ``PERF.md``).  Across devices the guest rows round as their donor's
  device rounds: the card and the CPU agree within the executor
  tolerance, not bit for bit.

The reference's ``prejit_sp`` warms JAX's compile caches for the
head-split step; PyTorch runs eagerly and the kernels are instantiated
per head dim, not per head count, so there is nothing to warm and it
has no counterpart here.

**Heterogeneous co-serving** (``bundles=``, ``serve.modelplane``): the
pool holds one executor + paged ``KVPool`` per *(bundle, lane)*, each
with that model's params and geometry.  Every stream is pinned to its
bundle (``model_of``) and all routing (``executor_of`` / ``serving_ex``,
migrate, SP expand / release) resolves through ``ex_for(lane, model)``,
so re-homing and elastic SP are same-model-only by construction.  The
primary bundle's executors are ``executors``, built as a single-model
pool builds them, so a single-bundle pool is that pool.
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LanePool:
    """One ``BatchedChunkExecutor`` per lane + the decision apply layer.

    ``lane_of`` maps every admitted stream to its current home lane;
    migrations move it.  Counters (``n_migrations``, ``n_sp_expands``,
    ``n_sp_releases``) record decisions actually *applied* — the
    control plane separately counts decisions *planned*.
    """

    def __init__(self, n_lanes: int = 1, cfg: Any = None, params: Any = None,
                 seed: int = 0, max_streams: int = 16,
                 context_backend: str = "paged",
                 engine: Optional[AsyncTransferEngine] = None,
                 sp_mode: str = "auto", page_evict: bool = False,
                 device: Any = "cuda",
                 devices: Optional[Sequence[Any]] = None,
                 bundles: Optional[Sequence[Any]] = None):
        if n_lanes < 1:
            raise ValueError(f"n_lanes {n_lanes}: at least 1")
        if sp_mode not in ("auto", "solo", "batch"):
            raise ValueError(
                f"sp_mode {sp_mode!r}: 'auto', 'solo' or 'batch'")
        # lane i on devices[i % n] (the reference's round-robin over its
        # runtime's devices); without ``devices`` every lane on ``device``
        self.lane_devices = ([torch.device(devices[i % len(devices)])
                              for i in range(n_lanes)] if devices
                             else [torch.device(device)] * n_lanes)
        if bundles:
            cfg, params = bundles[0].cfg, bundles[0].params
        first = BatchedChunkExecutor(cfg=cfg, params=params, seed=seed,
                                     max_streams=max_streams,
                                     context_backend=context_backend,
                                     engine=engine,
                                     device=self.lane_devices[0],
                                     page_evict=page_evict)
        executors = [first] + [
            BatchedChunkExecutor(cfg=first.cfg, params=first.params,
                                 max_streams=max_streams,
                                 context_backend=context_backend,
                                 engine=first.pool.engine,
                                 device=self.lane_devices[lane],
                                 page_evict=page_evict)
            for lane in range(1, n_lanes)]
        self._init(executors, first.pool.engine, sp_mode)
        if bundles:
            self.bundle_executors[bundles[0].name] = self.executors
            for b in bundles[1:]:
                self.bundle_executors[b.name] = [
                    BatchedChunkExecutor(cfg=b.cfg, params=b.params,
                                         max_streams=max_streams,
                                         context_backend=context_backend,
                                         engine=self.engine,
                                         device=self.lane_devices[lane],
                                         page_evict=page_evict)
                    for lane in range(n_lanes)]

    @classmethod
    def wrap(cls, executor: Any) -> "LanePool":
        """Single-lane pool around an existing executor (the session's
        ``executor=`` injection; also adapts the sequential whole-chunk
        executor, which has no page pool)."""
        self = cls.__new__(cls)
        pool = getattr(executor, "pool", None)
        self.lane_devices = [executor.device]
        self._init([executor],
                   pool.engine if pool is not None else executor.engine,
                   "auto")
        return self

    def _init(self, executors: List[Any], engine: AsyncTransferEngine,
              sp_mode: str):
        self.executors = executors
        self.engine = engine
        self.sp_mode = sp_mode
        self.lane_of: Dict[int, int] = {}
        # co-served bundles: model -> its executor per lane, and each
        # stream's model (both empty on a single-model pool)
        self.bundle_executors: Dict[str, List[Any]] = {}
        self.model_of: Dict[int, str] = {}
        self.n_migrations = 0
        self.n_sp_expands = 0
        self.n_sp_releases = 0

    # ---- views -------------------------------------------------------------
    @property
    def n_lanes(self) -> int:
        return len(self.executors)

    def ex(self, lane: int) -> Any:
        return self.executors[lane]

    def ex_for(self, lane: int, model: Optional[str] = None) -> Any:
        """The executor of ``lane`` serving ``model``'s bundle; the
        primary executors when ``model`` is None or unknown."""
        if model is not None and model in self.bundle_executors:
            return self.bundle_executors[model][lane]
        return self.executors[lane]

    @property
    def all_executors(self) -> List[Any]:
        """Every executor across bundles, the primary bundle's first."""
        out = list(self.executors)
        for exs in self.bundle_executors.values():
            if exs is not self.executors:
                out.extend(exs)
        return out

    def executor_of(self, sid: int) -> Any:
        return self.ex_for(self.lane_of.get(sid, 0), self.model_of.get(sid))

    def chunks_of(self, sid: int) -> List[Any]:
        return self.executor_of(sid).chunks.get(sid, [])

    def serving_ex(self, sid: int) -> Any:
        """The executor currently SERVING ``sid``: its donor lane during
        a batch-axis SP borrow (the stream runs there as a guest batch
        row), its home lane otherwise."""
        link = self.sp_link(sid)
        if link is not None and link.mode == "batch":
            return self.ex_for(link.donor, self.model_of.get(sid))
        return self.executor_of(sid)

    def is_inflight(self, sid: int) -> bool:
        return sid in self.serving_ex(sid).inflight

    def any_inflight(self) -> bool:
        return any(ex.inflight for ex in self.all_executors)

    def sp_link(self, sid: int) -> Optional[SPLink]:
        return getattr(self.executor_of(sid), "sp_links", {}).get(sid)

    def remaining_estimate(self, sid: int) -> float:
        return self.serving_ex(sid).remaining_estimate(sid)

    def latency_ema_get(self, key: str, default: float,
                        model: Optional[str] = None) -> float:
        """Measured chunk-latency EMA for a fidelity, averaged over the
        lanes that have observed it (their EMAs estimate the same
        quantity where the lanes' devices are of one kind).  ``model``
        scopes the read to that bundle's executors: fidelity keys collide
        across co-served models."""
        exs = (self.bundle_executors.get(model, self.executors)
               if model is not None else self.executors)
        vals = [ex.latency_ema[key] for ex in exs
                if key in ex.latency_ema]
        return sum(vals) / len(vals) if vals else default

    # ---- stream lifecycle (routed to the home lane) ------------------------
    def admit(self, sid: int, lane: int, seed: int = 0,
              streams: Optional[Dict[int, Stream]] = None,
              protect: Sequence[int] = (),
              model: Optional[str] = None) -> bool:
        self.lane_of[sid] = lane
        if model is not None:
            self.model_of[sid] = model
        else:
            self.model_of.pop(sid, None)      # sid reuse across models
        return self.ex_for(lane, model).admit(sid, seed=seed,
                                              streams=streams,
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
        # model_of is kept: the generated chunks stay in the bundle's
        # executor, so chunks_of / handle reads still route there

    # ---- real device moves -------------------------------------------------
    def _measured_put(self, pages: Dict[str, torch.Tensor], device: Any,
                      *, cross_node: bool = False,
                      kind: str = "move") -> Dict[str, torch.Tensor]:
        """Move a dict of tensors (a stream's ``k`` / ``v`` pages) onto
        ``device`` with ``.to``, timing the copy wall to wall (the
        source devices synchronized first, so pending compute does not
        count; the destination after) and recording the measured move on
        the shared engine, which calibrates its bandwidth model from the
        observed bytes/s."""
        device = torch.device(device)
        for dev in {t.device for t in pages.values()}:
            _sync(dev)
        t0 = time.perf_counter()
        moved = {n: t.to(device) for n, t in pages.items()}
        _sync(device)
        self.engine.record_measured(sum(_nbytes(t) for t in pages.values()),
                                    time.perf_counter() - t0,
                                    cross_node=cross_node, kind=kind)
        return moved

    # ---- decision apply: re-homing -----------------------------------------
    def migrate(self, sid: int, src: int, dst: int, *,
                cross_node: bool = False) -> bool:
        """Apply one ``rehoming.Migration`` as a real KV move.  Returns
        False (decision dropped) when the stream is mid-chunk, SP-linked
        or not on ``src`` — states the planner excludes, re-checked here
        because the executor, not the planner, owns ground truth.

        Lanes on different devices take the DIRECT path: the source's
        resident pages are handed over as device tensors and moved onto
        the destination lane's device (measured, recorded on the
        engine), landing straight in the destination page table — no
        host round trip.  Lanes on one device (or a parked source
        stream, or a full destination pool) keep the host-spill path:
        the pages go to host memory and the destination adopts them,
        landing them in its pool right away when there is room.  Either
        way the stream's KV is bit-identical after the move."""
        if self.lane_of.get(sid) != src or src == dst:
            return False
        # same-model-only: both ends are the stream's own bundle's
        # executor on each lane
        model = self.model_of.get(sid)
        src_ex, dst_ex = self.ex_for(src, model), self.ex_for(dst, model)
        if sid in src_ex.inflight or sid in src_ex.sp_links:
            return False
        direct = (dst_ex.device != src_ex.device
                  and src_ex.pool.resident(sid)
                  and dst_ex.pool.can_admit())
        state = src_ex.export_stream(sid, to_host=not direct)
        src_ex.pool.transfer_bytes_out += (_nbytes(state["pages"]["k"])
                                           + _nbytes(state["pages"]["v"]))
        if direct:
            state["pages"] = self._measured_put(
                state["pages"], dst_ex.device, cross_node=cross_node,
                kind="migration")
        dst_ex.import_stream(sid, state, cross_node=cross_node,
                             direct=direct)
        self.lane_of[sid] = dst
        # land it in the destination pool right away when there is room
        # — the import already charged the src->dst move, so this
        # restore is free; under pressure the stream stays parked and
        # rejoins via ensure_resident (a genuine second movement,
        # charged then).  The direct path is already page-resident.
        if not direct and dst_ex.pool.can_admit():
            dst_ex.pool.restore(sid, charge=False)
            dst_ex._boundary_cache.clear()
        self.n_migrations += 1
        return True

    # ---- decision apply: elastic SP ----------------------------------------
    def _sp_mode_for(self, home_ex: Any, donor_ex: Any) -> str:
        """Serving mode of a new SP link.  Lanes on DIFFERENT devices
        always use batch-axis SP: the head-split step reads both pools in
        one call, which cannot span two devices.  Lanes on one device
        take the solo head split unless ``sp_mode`` is "batch" ("auto"
        and "solo" alike, as in the reference)."""
        if home_ex.device != donor_ex.device:
            return "batch"
        return "batch" if self.sp_mode == "batch" else "solo"

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
        # same-model-only: the mirror lands in the donor lane's pool of
        # the stream's own bundle
        model = self.model_of.get(sid)
        ex = self.ex_for(home, model)
        if getattr(ex, "context_backend", None) != "paged":
            return False          # head split rides the paged step only
        if sid in ex.sp_links:
            return True
        if not ex.pool.resident(sid) and \
                not ex.ensure_resident(sid, streams, protect=[sid]):
            return False
        donor_ex = self.ex_for(donor, model)
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
        set (batch-axis SP): a measured move when the pools live on
        different devices.  Verbatim copy — the donor then serves the
        stream with the ordinary SP1 step over bit-identical values."""
        rows = torch.as_tensor(home.table_rows(sid), dtype=torch.long,
                               device=home.device)
        pages = {"k": home.k[:, rows], "v": home.v[:, rows]}
        if dpool.device != home.device:
            pages = self._measured_put(pages, dpool.device,
                                       kind="sp-expand")
        dpool._write(dpool.ledger.tables[sid], pages["k"], pages["v"])
        return _nbytes(pages["k"]) + _nbytes(pages["v"])

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
        donor_ex = self.ex_for(link.donor, self.model_of.get(sid))
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
