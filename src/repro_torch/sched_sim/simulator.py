"""Discrete-event cluster simulator (paper SS7 testbed on a virtual clock).

The simulator owns the event loop, playout bookkeeping, worker execution
and the paged-KV pools; ALL control decisions come from policy objects —
SlackServe's policy calls the real ``repro_torch.core`` control plane, baselines
implement SS7.1's SDV2 / TS / TS-chunk behaviors.  Execution is modeled at
*denoise-step* granularity, so step-boundary preemption (SS3.1) is exact.

Event kinds: arrival, tick, step_done, stream_ready (transfer finished /
atomic-safety reinsertion), prompt_switch, pause_end, worker_unblock.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import queues as q_mod
from repro_torch.core import slack as slack_mod
from repro_torch.core.control_plane import ControlPlane, ControlConfig
from repro_torch.core.fidelity import FidelityConfig, HIGHEST_QUALITY
from repro_torch.core.state_plane import AsyncTransferEngine, PagedKVPool
from repro_torch.core.types import ClusterView, Stream, Tier, Worker
from repro_torch.profiler.profiles import MODEL_COST, ModelProfile, get_profile
from repro_torch.sched_sim import cost_model as cm
from repro_torch.sched_sim.frontdoor import FrontDoor, FrontDoorConfig
from repro_torch.sched_sim.workloads import StreamSpec


@dataclasses.dataclass
class SimConfig:
    n_workers: int = cm.N_WORKERS
    workers_per_node: int = cm.WORKERS_PER_NODE
    model: str = "causal-forcing"
    transfer_protocol: str = "async-stream"
    tick_interval: float = 3.0
    pool_pages: int = cm.POOL_PAGES
    max_time: float = 3.0e4
    # --- calibration overrides (sched_sim.calibration fits these to a
    # real --lanes run; defaults are the analytic cost-model constants) ---
    chunk_seconds: float = cm.CHUNK_SECONDS
    bw_intra: float = cm.BW_INTRA
    bw_inter: float = cm.BW_INTER
    batch_alpha: Optional[float] = None   # sdv2_batch_step_factor slope
    profile: Optional[ModelProfile] = None   # calibrated latency surface
    # --- fleet front door (None = legacy unconditional admission) ---
    front_door: Optional[FrontDoorConfig] = None
    # numpy-batched control tick + fresh-credit dispatch ordering
    # (bit-identical to the scalar path; the fleet benchmark flips this
    # off to measure the pre-vectorization baseline)
    vectorized: bool = True


@dataclasses.dataclass
class SimResult:
    streams: Dict[int, Stream]
    engine: AsyncTransferEngine
    n_rehomings: int
    n_sp_events: int
    worker_tier_samples: List[Tuple[int, int, int]]   # (urgent, mixed, relaxed)
    fidelity_counts: Dict[str, int]
    control_tick_times: List[float]
    admission: Dict[str, int] = dataclasses.field(default_factory=dict)
    tick_wall: List[float] = dataclasses.field(default_factory=list)
    n_workers_final: int = 0


class Simulator:
    def __init__(self, config: SimConfig, specs: Sequence[StreamSpec],
                 policy: "Policy"):
        self.cfg = config
        self.specs = {s.sid: s for s in specs}
        self.policy = policy
        self.profile: ModelProfile = (config.profile
                                      or get_profile(config.model))
        self.engine = AsyncTransferEngine(
            protocol=config.transfer_protocol, bw_intra=config.bw_intra,
            bw_inter=config.bw_inter, overhead=cm.TRANSFER_OVERHEAD_S,
            n_layers=cm.N_LAYERS)
        workers = [Worker(w, node=w // config.workers_per_node)
                   for w in range(config.n_workers)]
        self.view = ClusterView({}, workers, config.workers_per_node)
        self.pools = [PagedKVPool(config.pool_pages)
                      for _ in range(config.n_workers)]
        self.blocked_until = [0.0] * config.n_workers
        self.in_transfer: Dict[int, float] = {}       # sid -> ready time
        self.now = 0.0
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._seq = itertools.count()
        self.worker_tier_samples: List[Tuple[int, int, int]] = []
        self.fidelity_counts: Dict[str, int] = {}
        # per-worker execution context: list of (sid) running in lockstep
        self.batch: List[List[int]] = [[] for _ in range(config.n_workers)]
        # batch generation counter per worker: a step_done event carries
        # the epoch it was scheduled under, so an aborted-then-restarted
        # batch with the SAME sid list cannot be credited a stale step
        self.batch_epoch: List[int] = [0] * config.n_workers
        # O(1) completion tracking (_all_done was an O(streams) scan per
        # event — the top cost in fleet-scale profiles)
        self._n_done = 0
        self._n_rejected = 0
        # fleet front door (admission + autoscaling)
        self.front_door: Optional[FrontDoor] = None
        if config.front_door is not None:
            self.front_door = FrontDoor(
                config.front_door,
                first_chunk_estimate=policy.first_chunk_estimate()
                if hasattr(policy, "profile") else 1.0)
        # wall-clock of each _on_tick handler (ticks/s benchmark metric)
        self.tick_wall: List[float] = []
        # True only inside a tick's dispatch fan-out, right after the
        # control tick refreshed every credit at self.now: policies may
        # then skip per-dispatch credit recomputation (exact: nothing
        # that feeds Eq. 1 for QUEUED streams mutates inside the loop)
        self._credits_fresh = False
        policy.attach(self)
        if self.front_door is not None and hasattr(policy, "control"):
            policy.control.attach_front_door(self.front_door)

    # ------------------------------------------------------------------ events
    def push(self, t: float, kind: str, payload: Any = None) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def run(self) -> SimResult:
        for spec in self.specs.values():
            self.push(spec.arrival, "arrival", spec.sid)
            for st in spec.switches:
                self.push(spec.arrival + st, "prompt_switch", spec.sid)
            for (ps, dur) in spec.pauses:
                self.push(spec.arrival + ps, "pause", (spec.sid, dur))
        self.push(self.cfg.tick_interval, "tick", None)

        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            if t > self.cfg.max_time:
                break
            self.now = t
            if kind == "tick":
                w0 = _time.perf_counter()
                self._on_tick(payload)
                self.tick_wall.append(_time.perf_counter() - w0)
            else:
                getattr(self, f"_on_{kind}")(payload)
                if self._all_done():
                    break
        return SimResult(self.view.streams, self.engine,
                         getattr(self.policy, "n_rehomings", 0),
                         getattr(self.policy, "n_sp_events", 0),
                         self.worker_tier_samples, self.fidelity_counts,
                         getattr(self.policy, "tick_times", []),
                         admission=(self.front_door.stats()
                                    if self.front_door else {}),
                         tick_wall=self.tick_wall,
                         n_workers_final=sum(1 for w in self.view.workers
                                             if not w.retired))

    def _all_done(self) -> bool:
        # O(1): every spec either finished serving or was shed by the
        # front door (equivalent to the old all(s.done) scan — a stream
        # waiting in the admission queue counts as neither)
        return self._n_done + self._n_rejected == len(self.specs)

    # ------------------------------------------------------------------ admission
    def _on_arrival(self, sid: int) -> None:
        first_est = self.policy.first_chunk_estimate()
        if self.front_door is not None:
            dec = self.front_door.on_arrival(self.view, self.now,
                                             first_est, sid)
            if dec.scale_workers:
                self.scale_out(dec.scale_workers)
            if dec.action == "reject":
                self._n_rejected += 1
                return
            if dec.action == "queue":
                return                 # drained at ticks / completions
        self._admit(sid, self.now, first_est)

    def _admit(self, sid: int, arrival: float, first_est: float) -> None:
        """Place an admitted stream (``arrival`` is the ORIGINAL arrival
        time: a front-door queue wait consumes the stream's TTFC slack,
        so its playout clock starts when the user asked, not when
        capacity appeared)."""
        spec = self.specs[sid]
        ttfc_slack = self.policy.initial_slack(first_est)
        home = self.policy.choose_home()
        s = Stream(sid=sid, arrival=arrival, target_chunks=spec.chunks,
                   chunk_seconds=self.cfg.chunk_seconds, home=home,
                   ttfc_slack=ttfc_slack,
                   next_deadline=arrival + ttfc_slack)
        s.t_next = first_est
        s.model = spec.model          # co-serving: None on legacy workloads
        self.view.streams[sid] = s
        self.policy.on_admit(s)
        self.view.workers[home].queue.append(sid)
        self.pools[home].alloc(sid, cm.SINK_PAGES)
        s.resident_on.add(home)
        self._try_dispatch(home)

    def _drain_front_door(self) -> None:
        fd = self.front_door
        admits, rejects = fd.drain(self.view, self.now)
        self._n_rejected += len(rejects)
        for sid, t_arr in admits:
            self._admit(sid, t_arr, self.policy.first_chunk_estimate())

    def scale_out(self, k: int) -> int:
        """Provision ``k`` workers (front-door autoscale).  Each lands
        after the cold-start ``provision_delay`` — modeled as a blocked
        dispatcher with a ``worker_unblock`` at readiness — and extends
        every per-worker array the event loop owns."""
        cfg = self.cfg
        delay = (self.front_door.cfg.provision_delay
                 if self.front_door else 0.0)
        for _ in range(k):
            # revive a retired worker before growing the arrays: its
            # slot (pool, batch lane, dispatcher) is already there, but
            # it still pays the same cold-start delay
            revive = next((w for w in self.view.workers if w.retired),
                          None)
            if revive is not None:
                revive.retired = False
                self.blocked_until[revive.wid] = self.now + delay
                self.push(self.now + delay, "worker_unblock", revive.wid)
                continue
            wid = len(self.view.workers)
            self.view.workers.append(
                Worker(wid, node=wid // cfg.workers_per_node))
            self.pools.append(PagedKVPool(cfg.pool_pages))
            self.blocked_until.append(self.now + delay)
            self.batch.append([])
            self.batch_epoch.append(0)
            self.push(self.now + delay, "worker_unblock", wid)
        return k

    def scale_in(self, k: int) -> int:
        """Retire up to ``k`` workers (front-door scale-in).  A retired
        worker keeps its wid slot — per-worker arrays are indexed by
        wid everywhere — but takes no dispatches, admissions,
        re-homings, or SP donations until revived.  Victims are drained
        first: queued streams re-home to the least-loaded surviving
        worker through the normal migration path (page-pool and
        transfer conservation intact); a worker actually RUNNING a
        chunk is never a victim.  Most-recently-provisioned workers
        retire first (LIFO, mirroring ``scale_out``)."""
        from repro_torch.core import rehoming
        retired = 0
        for w in sorted(self.view.workers, key=lambda x: -x.wid):
            if retired >= k:
                break
            if (w.retired or w.donated_to is not None
                    or w.running is not None or self.batch[w.wid]):
                continue
            survivors = [x for x in self.view.workers
                         if not x.retired and x.wid != w.wid
                         and x.donated_to is None]
            if not survivors:
                break
            for sid in list(w.queue):
                if not self._runnable(sid):
                    break
                dst = min(survivors, key=lambda x: x.load())
                mig = rehoming.Migration(
                    sid, w.wid, dst.wid,
                    self.view.node_of(w.wid) != self.view.node_of(dst.wid))
                rehoming.apply_migration(self.view, mig)
                self.migrate(sid, w.wid, dst.wid, mig.cross_node)
            if w.queue:
                continue                 # undrainable: keep it serving
            w.retired = True
            retired += 1
        return retired

    # ------------------------------------------------------------------ control
    def _on_tick(self, _: None) -> None:
        if self.front_door is not None:
            self._drain_front_door()
        self.policy.on_tick(self.now)
        # the control tick refreshed every credit at self.now; nothing
        # in the dispatch fan-out mutates a QUEUED stream's Eq. 1 inputs
        # (batch starts only remove streams from their own queue), so
        # order() may reuse them verbatim
        if self.cfg.vectorized:
            self._credits_fresh = True
        try:
            # sample worker classes (Fig. 15)
            if self.cfg.vectorized:
                self.worker_tier_samples.append(
                    q_mod.worker_class_triple(self.view))
            else:
                counts = q_mod.tier_counts(self.view)
                cls = [q_mod.worker_class(counts[w.wid])
                       for w in self.view.workers]
                self.worker_tier_samples.append(
                    (cls.count("urgent"), cls.count("mixed"),
                     cls.count("relaxed")))
            for w in self.view.workers:
                self._try_dispatch(w.wid)
        finally:
            self._credits_fresh = False
        if not self._all_done():
            self.push(self.now + self.cfg.tick_interval, "tick", None)

    # ------------------------------------------------------------------ playout
    def _on_prompt_switch(self, sid: int) -> None:
        s = self.view.streams.get(sid)
        if s is None or s.done:
            return
        # chunks buffered under the old condition are useless: slack resets
        s.next_deadline = self.now + s.ttfc_slack
        s.step_done = 0                        # abort in-flight chunk work
        s.remaining = 0.0
        s.chunk_started = None                 # fresh chunk, fresh fidelity
        # cancel the in-flight batch: without this the pending step_done
        # event still matches batch[wid] and credits the ABORTED chunk a
        # step, resuming the stale-condition chunk instead of restarting
        # it (the real executor's reset_condition drops the flight) —
        # batchmates lose only their current partial step and requeue at
        # the front with their progress intact
        run_wids = [w for w in range(len(self.batch))
                    if sid in self.batch[w]]
        if run_wids:
            members = list(self.batch[run_wids[0]])
            freed = set()
            for w2 in range(len(self.batch)):
                if self.batch[w2] and self.batch[w2][0] in members:
                    self.batch[w2] = []
                    freed.add(w2)
            for member in members:
                m = self.view.streams[member]
                back = (m.running_on[0] if m.running_on
                        else run_wids[0])
                m.running_on = None
                wq = self.view.workers[back].queue
                if member not in wq and not m.done:
                    wq.insert(0, member)
                freed.add(back)
            for w2 in freed:
                self._try_dispatch(w2)

    def _on_pause(self, payload: Tuple[int, float]) -> None:
        sid, dur = payload
        s = self.view.streams.get(sid)
        if s is None or s.done:
            return
        s.next_deadline += dur                 # playout halts; slack grows

    # ------------------------------------------------------------------ execution
    def _runnable(self, sid: int) -> bool:
        s = self.view.streams[sid]
        return (not s.done and not s.finished and sid not in self.in_transfer)

    def _try_dispatch(self, wid: int) -> None:
        w = self.view.workers[wid]
        if w.retired or self.batch[wid] or self.now < self.blocked_until[wid]:
            return
        if w.donated_to is not None:
            sid = w.donated_to
            s = self.view.streams[sid]
            home_w = self.view.workers[s.home]
            if (self._runnable(sid) and not self.batch[s.home]
                    and sid in home_w.queue
                    and self.now >= self.blocked_until[s.home]):
                self._start_batch(s.home, [sid], sp=2)
                return
            # donated stream not dispatchable right now: serve own queue
            # (the donor re-joins at the stream's next boundary)
        self.policy.order(w)
        cand: List[int] = []
        for sid in list(w.queue):
            if self._runnable(sid):
                s = self.view.streams[sid]
                if wid not in s.resident_on:
                    self._restore(sid, wid)      # non-resident: stream back
                    continue
                cand.append(sid)
                if len(cand) >= self.policy.batch_size:
                    break
        if cand:
            sp = 1
            s0 = self.view.streams[cand[0]]
            if (len(cand) == 1 and s0.sp_donor is not None):
                donor = self.view.workers[s0.sp_donor]
                if not self.batch[donor.wid] and \
                        self.now >= self.blocked_until[donor.wid]:
                    sp = 2
            self._start_batch(wid, cand[:1] if sp == 2 else cand, sp=sp)

    def _start_batch(self, wid: int, sids: List[int], sp: int = 1) -> None:
        w = self.view.workers[wid]
        b = len(sids)
        for sid in sids:
            s = self.view.streams[sid]
            if sid in w.queue:
                w.queue.remove(sid)
            if s.chunk_started is None or s.step_done == 0:
                fid, lat = self.policy.select_fidelity(s, self.now)
                s.next_fidelity = fid
                s.t_next = lat
                s.chunk_started = self.now
                s.step_done = 0
            s.running_on = ((wid, s.sp_donor) if sp == 2 and s.sp_donor
                            is not None else (wid,))
            step_t = self._step_time(s, b, sp)
            s.remaining = (s.next_fidelity.steps - s.step_done) * step_t
        self.batch[wid] = list(sids)
        self.batch_epoch[wid] += 1
        if sp == 2 and self.view.streams[sids[0]].sp_donor is not None:
            self.batch[self.view.streams[sids[0]].sp_donor] = list(sids)
        step_t = self._step_time(self.view.streams[sids[0]], b, sp)
        self.push(self.now + step_t, "step_done",
                  (wid, list(sids), self.batch_epoch[wid]))

    def _step_time(self, s: Stream, batch: int, sp: int) -> float:
        """Per-step wall time.  A lockstep batch of b shares the unit, so
        every member sees t_step * batch_factor(b); pipeline-parallel
        units (SDV2) divide the step time by their pipeline speedup.
        Co-served streams scale by their model's relative step cost
        (``MODEL_COST``, 1.0 for the primary — untagged streams are
        untouched)."""
        lat = self.profile.latency(s.next_fidelity, sp_degree=sp)
        if s.model is not None:
            cost = MODEL_COST.get(s.model, 1.0)
            if cost != 1.0:
                lat *= cost
        step = lat / s.next_fidelity.steps
        step /= getattr(self.policy, "pipeline_speedup", 1.0)
        if batch > 1:
            alpha = self.cfg.batch_alpha
            step *= (cm.sdv2_batch_step_factor(batch) if alpha is None
                     else cm.sdv2_batch_step_factor(batch, alpha))
        return step

    def _on_step_done(self, payload: Tuple[int, List[int], int]) -> None:
        wid, sids, epoch = payload
        # stale-event guard: the batch was preempted or aborted since
        # this event was scheduled.  The epoch check catches an aborted
        # batch RESTARTED with the same sid list (prompt switch -> fresh
        # chunk), which list equality alone would mistake for in-flight.
        if self.batch[wid] != sids or self.batch_epoch[wid] != epoch:
            return
        done_chunk: List[int] = []
        for sid in sids:
            s = self.view.streams[sid]
            s.step_done += 1
            sp = len(s.running_on or (wid,))
            step_t = self._step_time(s, len(sids), sp)
            s.remaining = (s.next_fidelity.steps - s.step_done) * step_t
            if s.step_done >= s.next_fidelity.steps:
                done_chunk.append(sid)
        if done_chunk:
            for sid in done_chunk:
                self._complete_chunk(sid, wid)
        # release batch and redispatch (step/chunk boundary = safe point)
        for sid in sids:
            s = self.view.streams[sid]
            if sid in done_chunk:
                continue
            # chunk unfinished: requeue at the FRONT with partial progress
            # (run-to-completion unless a lower-credit stream preempts at
            #  this safe boundary; FIFO policies simply continue it)
            s.running_on = None
            if sid not in self.view.workers[wid].queue and not s.done:
                self.view.workers[wid].queue.insert(0, sid)
        # free every worker that ran this batch (home + any SP2 mirror —
        # scan all mirrors so a mid-step donor release cannot leak one)
        freed = []
        for w2 in range(len(self.batch)):
            if self.batch[w2] == sids:
                self.batch[w2] = []
                freed.append(w2)
        for f in freed:
            self._try_dispatch(f)

    def _complete_chunk(self, sid: int, wid: int) -> None:
        s = self.view.streams[sid]
        ready = self.now
        ddl = s.next_deadline
        if self.front_door is not None and s.chunk_started is not None:
            self.front_door.observe_chunk(ready - s.chunk_started,
                                          fidelity=s.next_fidelity.key,
                                          model=s.model)
        s.ready_times.append(ready)
        s.deadlines.append(ddl)
        if s.first_chunk_time is None:
            s.first_chunk_time = ready
        if ready > ddl:
            s.stall_time += ready - ddl
            s.stall_events.append(ready - ddl)
        s.next_deadline = max(ddl, ready) + s.chunk_seconds
        s.chunks_done += 1
        s.step_done = 0
        s.chunk_started = None
        s.running_on = None
        s.remaining = 0.0
        fid = s.next_fidelity
        s.qualities.append(self.profile.quality(fid))
        s.fidelity_log.append(fid.key)
        self.fidelity_counts[fid.key] = self.fidelity_counts.get(
            fid.key, 0) + 1
        # KV growth: allocate this chunk's pages (evict if needed, SS4.1)
        self._grow_kv(sid, wid)
        if s.finished:
            s.done = True
            self._n_done += 1
            for w_res in list(s.resident_on):
                self.pools[w_res].release(sid)
            s.resident_on.clear()
            if s.sp_donor is not None:
                self.view.workers[s.sp_donor].donated_to = None
                s.sp_donor = None
            # freed capacity: promote front-door queued arrivals now
            # instead of waiting out the tick interval
            if self.front_door is not None and self.front_door.waiting:
                self._drain_front_door()
        else:
            self.view.workers[wid].queue.append(sid)

    # ------------------------------------------------------------------ state
    def _grow_kv(self, sid: int, wid: int) -> None:
        s = self.view.streams[sid]
        pool = self.pools[wid]
        want = cm.stream_pages(s.chunks_done, model=s.model)
        delta = want - pool.pages_of(sid)
        if delta <= 0:
            return
        while not pool.can_alloc(delta):
            victim = q_mod.pick_eviction(
                [x for x in pool.resident_sids()
                 if self.view.streams[x].running_on is None],
                self.view.streams, protect=sid)
            if victim is None:
                return                          # nothing evictable
            pool.release(victim)
            self.view.streams[victim].resident_on.discard(wid)
        pool.alloc(sid, delta)
        s.resident_on.add(wid)

    def _restore(self, sid: int, wid: int) -> None:
        """Evicted stream selected for dispatch: stream state back in
        (host->device modeled at intra-node bandwidth)."""
        s = self.view.streams[sid]
        w = self.view.workers[wid]
        if sid in w.queue:
            w.queue.remove(sid)
        n_bytes = cm.stream_bytes(s.chunks_done, model=s.model)
        timing = self.engine.transfer(self.now, n_bytes, cross_node=False)
        self.in_transfer[sid] = timing.first_layer_ready
        pool = self.pools[wid]
        want = cm.stream_pages(s.chunks_done, model=s.model)
        while not pool.can_alloc(want):
            victim = q_mod.pick_eviction(
                [x for x in pool.resident_sids()
                 if self.view.streams[x].running_on is None],
                self.view.streams, protect=sid)
            if victim is None:
                break
            pool.release(victim)
            self.view.streams[victim].resident_on.discard(wid)
        pool.alloc(sid, min(want, pool.free))
        s.resident_on.add(wid)
        self.push(timing.first_layer_ready, "stream_ready", (sid, wid))
        if self.engine.blocks_dispatcher():
            self.blocked_until[wid] = timing.complete
            # wake the dispatcher when the blocking restore finishes
            # (mirrors migrate(): without the event the worker idled
            # until the next 3 s control tick)
            self.push(timing.complete, "worker_unblock", wid)

    def _on_stream_ready(self, payload: Tuple[int, int]) -> None:
        sid, wid = payload
        self.in_transfer.pop(sid, None)
        s = self.view.streams.get(sid)
        if s is None or s.done:
            return
        w = self.view.workers[wid]
        if sid not in w.queue and s.running_on is None:
            w.queue.append(sid)
        self._try_dispatch(wid)

    def _on_worker_unblock(self, wid: int) -> None:
        self._try_dispatch(wid)

    # ------------------------------------------------------------------ used by policies
    def migrate(self, sid: int, src: int, dst: int,
                cross_node: bool) -> None:
        """Re-homing state movement through the State Plane (SS4.4)."""
        s = self.view.streams[sid]
        n_bytes = cm.stream_bytes(s.chunks_done, model=s.model)
        timing = self.engine.transfer(self.now, n_bytes,
                                      cross_node=cross_node)
        self.pools[src].release(sid)
        s.resident_on.discard(src)
        pool = self.pools[dst]
        want = cm.stream_pages(s.chunks_done, model=s.model)
        while not pool.can_alloc(want):
            victim = q_mod.pick_eviction(
                [x for x in pool.resident_sids()
                 if self.view.streams[x].running_on is None],
                self.view.streams, protect=sid)
            if victim is None:
                break
            pool.release(victim)
            self.view.streams[victim].resident_on.discard(dst)
        pool.alloc(sid, min(want, pool.free))
        s.resident_on.add(dst)
        # atomic safety: out of every queue until first layer lands
        for w in self.view.workers:
            if sid in w.queue:
                w.queue.remove(sid)
        self.in_transfer[sid] = timing.first_layer_ready
        self.push(timing.first_layer_ready, "stream_ready", (sid, dst))
        if self.engine.blocks_dispatcher():
            self.blocked_until[dst] = timing.complete
            self.push(timing.complete, "worker_unblock", dst)

    def sp_head_partition_transfer(self, sid: int, donor: int) -> None:
        """Ulysses head-partition KV to the donor (App. C.4): half bytes."""
        s = self.view.streams[sid]
        n_bytes = cm.stream_bytes(s.chunks_done, model=s.model) // 2
        timing = self.engine.transfer(self.now, n_bytes, cross_node=False)
        self.in_transfer[sid] = timing.first_layer_ready
        for w in self.view.workers:
            if sid in w.queue:
                w.queue.remove(sid)
        self.push(timing.first_layer_ready, "stream_ready", (sid, s.home))


# ---------------------------------------------------------------------------
# policy interface
# ---------------------------------------------------------------------------

class Policy:
    name = "base"
    batch_size = 1

    def attach(self, sim: Simulator) -> None:
        self.sim = sim

    # admission
    def first_chunk_estimate(self) -> float:
        raise NotImplementedError

    def initial_slack(self, first_est: float) -> float:
        return 4.0 * first_est

    def choose_home(self) -> int:
        return min(self.sim.view.workers, key=lambda w: w.load()).wid

    def on_admit(self, s: Stream) -> None:
        pass

    # control
    def on_tick(self, now: float) -> None:
        pass

    def order(self, worker: Worker) -> None:
        pass

    def select_fidelity(self, s: Stream,
                        now: float) -> Tuple[FidelityConfig, float]:
        raise NotImplementedError
