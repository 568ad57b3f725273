"""StreamingSession: ONE control plane, ONE workload spec, ONE metrics
surface over the real executor.

* requests are submitted as ``sched_sim.workloads.StreamSpec``s —
  online arrivals, per-stream chunk counts, pause and prompt-switch
  events — exactly the objects every workload generator produces;
* stream lifecycle is exposed through handles
  (``submit() -> StreamHandle``, ``.chunks_ready``, ``.done``);
* the scheduling loop is driven by ``ControlPlane.tick()`` (BMPR
  fidelity -> Eq. 1 service credit -> three-tier queue ordering) with
  the executor as the apply layer: the batched executor (micro-batches
  over the paged KV pool, ``context_backend`` "paged" or "gather") or
  the sequential one (whole chunks, one stream at a time);
* every stream's playout timeline lives in ONE per-stream record
  (``core.types.Stream``), so ``sched_sim.metrics.summarize()`` gives
  the same CPR / TTFC / stall Summary as over a simulation.

Budget units: the offline profile's latencies are H100-calibrated while
the session's clock is the wall clock, so the session measures one
top-fidelity warm-up chunk and scales Eq. 1 budgets by
``time_scale = profile.latency(HIGHEST_QUALITY) / measured_top_latency``
(``_HostCalibratedPolicy``); a fidelity's measured-latency EMA replaces
the scaled profile estimate once it exists (online re-profiling).

Multi-lane sessions (``SessionConfig.lanes > 1``): the session owns a
``serve.lanes.LanePool`` — one ``BatchedChunkExecutor`` (own paged KV
pool) per lane, all on ``SessionConfig.device`` (default the card) or
round-robin over ``SessionConfig.devices``, lanes grouped into nodes via
``workers_per_node`` — and the cluster view grows one Worker per lane,
which turns on the cross-worker mechanisms: ``rehoming.Migration``
decisions become real cross-lane KV moves and ``elastic_sp.SPDecision``
a real Ulysses head-split SP2 step over the donor lane's pool, or a
batch-axis borrow between lanes on different devices (released at the
next safe boundary).

Co-served models (``SessionConfig.models``, ``serve.modelplane``): one
executor + paged KV pool per (model, lane), each stream routed to its
spec's model, placement weighted by per-model step / page cost, every
bundle calibrated by its own warm-up chunk, re-homing and elastic SP
same-model-only.  ``step_cache`` unlocks the step-cache levels in the
BMPR candidate space (``models/stepcache``).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import elastic_sp, queues, rehoming, slack
from repro_torch.core.bmpr import BMPR, BMPRDecision
from repro_torch.core.control_plane import (ControlConfig, ControlPlane,
                                            TickDecisions)
from repro_torch.core.elastic_sp import SPDecision
from repro_torch.core.fidelity import FidelityConfig, HIGHEST_QUALITY
from repro_torch.core.state_plane import AsyncTransferEngine
from repro_torch.core.types import ClusterView, Stream, Worker
from repro_torch.profiler import trace
from repro_torch.profiler.profiles import get_profile
from repro_torch.sched_sim import cost_model as cm
from repro_torch.sched_sim.frontdoor import FrontDoor, FrontDoorConfig
from repro_torch.sched_sim.workloads import StreamSpec
from repro_torch.serve.batcher import compose_batch
from repro_torch.serve.executor import SequentialChunkExecutor, ServedStream
from repro_torch.serve.lanes import LanePool
from repro_torch.serve.modelplane import profile_name_of, resolve_bundles


@dataclasses.dataclass
class SessionConfig:
    """Knobs of a real-model serving session.

    ``executor`` is ``"batched"`` (micro-batches over the paged KV pool;
    ``context_backend`` ``"paged"`` or ``"gather"``) or ``"sequential"``
    (whole chunks, one stream at a time; ``max_batch`` does not apply).
    ``lanes`` is the number of batched executors (one KV pool each; > 1
    turns on re-homing and elastic SP), ``workers_per_node`` groups them
    into nodes for Algorithm 1's and SS4.3's intra-node preferences (0 =
    all lanes in one node).
    ``device`` is where the executor's params, KV pool and kernels live
    (default the card; ``"cpu"`` runs the plain PyTorch versions);
    ``devices`` (batched executor) round-robins the lanes over these
    devices instead, lane i on ``devices[i % len(devices)]``.
    ``pool_streams`` caps co-resident streams in the page pool.
    ``tick_interval`` is the control-tick cadence in session seconds; 0
    runs Algorithm 2 at every scheduler iteration.  ``arrival_scale``
    multiplies every StreamSpec time.  ``realtime_budget`` fixes the
    playout seconds per chunk; None calibrates ``budget_factor`` x the
    measured top-fidelity latency.
    """
    executor: str = "batched"
    max_batch: int = 4
    lanes: int = 1
    workers_per_node: int = 0
    pool_streams: Optional[int] = None
    context_backend: str = "paged"
    # fused heterogeneous-fidelity dispatch: micro-batches group by KV
    # quantization dtype only (steps/window/sparsity ride as per-row
    # data); False restores per-key split dispatch
    fuse_fidelity: bool = True
    # partial-window residency: under pool pressure evict single ring
    # pages before whole-stream spill (discards KV)
    page_evict: bool = False
    # the step cache (fifth fidelity knob): True unlocks the cache levels
    # in the BMPR candidate space (270 points); cache levels also work
    # when a custom ``fidelity_policy`` selects them
    step_cache: bool = False
    model_cfg: Optional[Any] = None    # None -> the reduced default model
    # co-served models: registry arch ids (reduced), ModelConfigs or
    # ready ``modelplane.ModelBundle``s; excludes ``model_cfg`` and an
    # injected executor
    models: Optional[List[Any]] = None
    realtime_budget: Optional[float] = None
    budget_factor: float = 4.0     # chunk_seconds = factor x top latency
    tick_interval: float = 0.0
    arrival_scale: float = 1.0
    seed: int = 0
    verbose: bool = True
    # SLO-aware admission control (sched_sim.frontdoor); autoscaling is
    # forced OFF in a real session
    front_door: Optional[FrontDoorConfig] = None
    device: Any = "cuda"
    devices: Optional[List[Any]] = None


@dataclasses.dataclass
class SessionResult:
    """Same surface as the simulator's ``SimResult`` — one metrics
    language for simulated and real runs (``metrics.summarize`` accepts
    either)."""
    streams: Dict[int, Stream]
    engine: AsyncTransferEngine
    n_rehomings: int
    n_sp_events: int
    worker_tier_samples: List[Tuple[int, int, int]]
    fidelity_counts: Dict[str, int]
    control_tick_times: List[float]
    n_migrations_applied: int = 0
    n_sp_expands_applied: int = 0
    n_sp_releases_applied: int = 0
    admission: Dict[str, int] = dataclasses.field(default_factory=dict)
    # per-stream effective-window history (chunks of context each
    # generated chunk actually attended to)
    effective_window: Dict[int, List[int]] = dataclasses.field(
        default_factory=dict)
    step_cache: Dict[str, float] = dataclasses.field(default_factory=dict)


class StreamHandle:
    """Client-side view of one submitted stream (the per-stream record
    appears once the stream's arrival time is reached inside
    ``run()``)."""

    def __init__(self, session: "StreamingSession", spec: StreamSpec):
        self._session = session
        self.spec = spec

    @property
    def sid(self) -> int:
        return self.spec.sid

    @property
    def record(self) -> Optional[Stream]:
        return self._session.view.streams.get(self.sid)

    @property
    def chunks_ready(self) -> int:
        return len(self._session.lanes.chunks_of(self.sid))

    @property
    def chunks(self) -> List[Any]:
        """Generated latent chunks, in playout order."""
        return list(self._session.lanes.chunks_of(self.sid))

    @property
    def done(self) -> bool:
        r = self.record
        return r is not None and r.finished

    @property
    def fidelity_log(self) -> List[str]:
        r = self.record
        return list(r.fidelity_log) if r is not None else []

    def served_stream(self) -> ServedStream:
        return self._session._served_stream(self.sid)


class _HostCalibratedPolicy:
    """Budget adapter between wall-second Eq. 1 budgets and a fidelity
    policy whose frontier is in offline-profile latency units.

    ``select(B)`` hands the wrapped policy ``B * time_scale`` and
    converts the decision's latency estimate back to wall seconds —
    replaced by the measured EMA for that fidelity as soon as one exists
    (online re-profiling).  Deliberately does NOT expose ``.profile``:
    ``ControlPlane.tick`` then takes T_u from the returned decision.
    ``model`` (co-served bundles) scopes the EMA read to that bundle's
    executors: fidelity keys collide across models.
    """

    def __init__(self, inner, lanes: LanePool, time_scale: float,
                 model: Optional[str] = None):
        self.inner = inner
        self.lanes = lanes
        self.time_scale = time_scale
        self.model = model

    def select(self, budget: float) -> BMPRDecision:
        dec = self.inner.select(budget * self.time_scale)
        lat = self.lanes.latency_ema_get(dec.fidelity.key,
                                         dec.latency / self.time_scale,
                                         model=self.model)
        return BMPRDecision(dec.fidelity, lat, dec.quality, dec.mode)


class _ModelRoutedPolicy:
    """Fidelity-policy multiplexer for co-served bundles: one
    ``_HostCalibratedPolicy`` per model (each over its bundle's offline
    profile, time scale and measured EMAs).  ``select`` serves the
    session primary; per-stream calls go through ``select_for(model,
    budget)``.  Like the single-model wrapper it does NOT expose
    ``.profile``, so T_u comes from the returned decision."""

    def __init__(self, by_model: Dict[str, _HostCalibratedPolicy],
                 primary: str):
        self.by_model = by_model
        self.primary = by_model[primary]

    def select(self, budget: float) -> BMPRDecision:
        return self.primary.select(budget)

    def select_for(self, model: Optional[str],
                   budget: float) -> BMPRDecision:
        return self.by_model.get(model, self.primary).select(budget)


def uniform_specs(n_streams: int, chunks_per_stream: int) -> List[StreamSpec]:
    """All-arrive-at-t=0 specs with exact chunk counts."""
    frames = chunks_per_stream * cm.PIXEL_FRAMES_PER_CHUNK
    return [StreamSpec(sid=i, arrival=0.0, frames=frames)
            for i in range(n_streams)]


def cap_specs(specs: List[StreamSpec],
              max_chunks: int) -> List[StreamSpec]:
    """Trim every spec to at most ``max_chunks`` chunks; arrivals and
    event times are kept."""
    return [dataclasses.replace(
        s, frames=min(s.frames, max_chunks * cm.PIXEL_FRAMES_PER_CHUNK))
        for s in specs]


def scale_specs(specs: List[StreamSpec],
                max_chunks: int) -> List[StreamSpec]:
    """Proportionally shrink spec lengths so the LONGEST stream runs
    ``max_chunks`` chunks and the relative length diversity survives;
    arrivals and event times are kept."""
    longest = max(s.chunks for s in specs)
    return [dataclasses.replace(
        s, frames=max(1, round(s.chunks * max_chunks / longest))
        * cm.PIXEL_FRAMES_PER_CHUNK) for s in specs]


class StreamingSession:
    """One serving session over the real executor, driven by the
    paper's control plane.

    Usage::

        session = StreamingSession(SessionConfig(max_batch=4))
        handles = [session.submit(spec) for spec in workloads.burst(n=6)]
        result = session.run()                 # SessionResult
        summary = sched_sim.metrics.summarize(result)

    ``submit`` only registers the spec; admission happens inside
    ``run()`` when the session clock reaches ``spec.arrival`` (scaled by
    ``config.arrival_scale``).  Prompt switches reset playout slack to
    the initial TTFC, abort the in-flight chunk and re-encode a fresh
    conditioning; pauses extend the playout deadline by their duration.
    ``executor=`` injects a ready ``BatchedChunkExecutor`` or
    ``SequentialChunkExecutor`` (its device, model and params win over
    the config's), or a ready ``serve.lanes.LanePool`` (its lanes win
    over ``lanes``).  The sequential executor is single-lane and serves
    one stream per step.  With ``lanes > 1`` new streams are homed on
    the least-loaded non-donating lane (``ControlPlane.choose_home``).
    """

    def __init__(self, config: Optional[SessionConfig] = None, *,
                 executor: Optional[Any] = None,
                 fidelity_policy: Optional[Any] = None):
        self.cfg = config or SessionConfig()
        if self.cfg.executor not in ("batched", "sequential"):
            raise ValueError(f"executor {self.cfg.executor!r}: 'batched' "
                             "or 'sequential'")
        n_lanes = max(1, self.cfg.lanes)
        self.bundles = None
        if self.cfg.models:
            if executor is not None or self.cfg.model_cfg is not None:
                raise ValueError("SessionConfig.models excludes executor= "
                                 "and model_cfg")
            if self.cfg.executor != "batched":
                raise ValueError("co-served models ride the batched paged "
                                 "executor")
            self.bundles = resolve_bundles(
                self.cfg.models, seed=self.cfg.seed,
                step_cache=self.cfg.step_cache, device=self.cfg.device)
        if n_lanes > 1 and not isinstance(executor, LanePool) and (
                executor is not None or self.cfg.executor == "sequential"):
            raise ValueError("multi-lane sessions take batched executors "
                             "(lanes > 1 takes a LanePool as executor=, "
                             "or none, and not the sequential executor)")
        if isinstance(executor, LanePool):
            self.lanes = executor
        elif executor is not None:
            self.lanes = LanePool.wrap(executor)
        elif self.cfg.executor == "sequential":
            self.lanes = LanePool.wrap(SequentialChunkExecutor(
                cfg=self.cfg.model_cfg, seed=self.cfg.seed,
                device=self.cfg.device))
        else:
            self.lanes = LanePool(
                n_lanes, cfg=self.cfg.model_cfg, seed=self.cfg.seed,
                max_streams=self.cfg.pool_streams or 16,
                context_backend=self.cfg.context_backend,
                page_evict=self.cfg.page_evict, device=self.cfg.device,
                devices=self.cfg.devices, bundles=self.bundles)
        self.executor = self.lanes.ex(0)

        if self.bundles is not None and fidelity_policy is None:
            inner_policies = {b.name: BMPR(b.profile)
                              for b in self.bundles}
            policy = inner_policies[self.bundles[0].name]
        else:
            inner_policies = None
            policy = fidelity_policy or BMPR(
                get_profile(step_cache=self.cfg.step_cache))
        self._profile = getattr(policy, "profile", None) or get_profile()
        self._bundle_profiles = (
            {b.name: b.profile for b in self.bundles}
            if self.bundles is not None else {})

        # ---- host calibration (one top-fidelity warm-up chunk) ----------
        # measures this device's top-fidelity chunk latency and fixes the
        # wall<->profile time scale of the Eq. 1 budgets
        ex = self.executor
        ex.admit(-1, seed=999)
        ex.begin_chunk(-1, HIGHEST_QUALITY, 0.0)
        while -1 in ex.inflight:
            ex.run_step([-1])
        self.top_latency = ex.latency_ema[HIGHEST_QUALITY.key]
        # drop the calibration stream WITH its history: sid -1 must not
        # leak pages or generated chunks into the serving session
        ex.retire(-1, drop_history=True)
        step = self.top_latency / (HIGHEST_QUALITY.steps + 1)
        for lex in self.lanes.executors:
            lex.latency_ema[HIGHEST_QUALITY.key] = self.top_latency
            if hasattr(lex, "step_ema"):
                lex.step_ema[HIGHEST_QUALITY.key] = step
        self.chunk_seconds = (self.cfg.realtime_budget
                              or self.cfg.budget_factor * self.top_latency)
        time_scale = (self._profile.latency(HIGHEST_QUALITY)
                      / max(self.top_latency, 1e-9))
        if self.bundles is not None:
            self._calibrate_bundles(time_scale)
        multi = self.lanes.n_lanes > 1
        if self.bundles is not None:
            fid_policy: Any = _ModelRoutedPolicy(
                {b.name: _HostCalibratedPolicy(
                    (inner_policies[b.name] if inner_policies is not None
                     else policy),
                    self.lanes, b.time_scale, model=b.name)
                 for b in self.bundles},
                primary=self.bundles[0].name)
        else:
            fid_policy = _HostCalibratedPolicy(policy, self.lanes,
                                               time_scale)
        self.control = ControlPlane(
            ControlConfig(tick_interval=self.cfg.tick_interval,
                          # cross-worker mechanisms need >1 lane
                          use_rehoming=multi, use_elastic_sp=multi),
            fidelity_policy=fid_policy)

        # ---- front door (admission control; autoscale forced off) -------
        self.front_door: Optional[FrontDoor] = None
        self._n_rejected = 0
        if self.cfg.front_door is not None:
            self.front_door = FrontDoor(
                dataclasses.replace(self.cfg.front_door, autoscale=False),
                first_chunk_estimate=self.top_latency)
            self.control.attach_front_door(self.front_door)

        # ---- cluster view: one Worker per lane --------------------------
        wpn = self.cfg.workers_per_node or self.lanes.n_lanes
        self.workers = [Worker(i, node=i // wpn)
                        for i in range(self.lanes.n_lanes)]
        self.worker = self.workers[0]
        self.view = ClusterView({}, self.workers, wpn)
        if self.bundles is not None:
            # placement sees per-model weight: a heavy-model stream
            # occupies more of a worker than a cheap one
            weights = {b.name: b.placement_weight for b in self.bundles}
            self.view.stream_weight = (
                lambda sid: weights.get(self.lanes.model_of.get(sid), 1.0))
            # spec.model takes the registry arch id or its profile alias
            # ("self-forcing" -> "ardit-self-forcing")
            self._model_alias = {}
            for b in self.bundles:
                self._model_alias[b.name] = b.name
                self._model_alias[profile_name_of(b.name)] = b.name
        self.handles: Dict[int, StreamHandle] = {}
        self._order: List[int] = []
        self._events: List[Tuple[float, int, str, Any]] = []
        self._eseq = itertools.count()
        self._pending_arrivals = 0
        self._t0: Optional[float] = None
        self._next_tick = 0.0
        self._switches: Dict[int, int] = {}
        self._pending_sp_release: Dict[int, int] = {}
        self.fidelity_counts: Dict[str, int] = {}
        self.worker_tier_samples: List[Tuple[int, int, int]] = []

    # ---- submission --------------------------------------------------------
    def submit(self, spec: StreamSpec) -> StreamHandle:
        """Register one stream request.  Times in the spec are relative
        to session start (``run()``), scaled by ``arrival_scale``."""
        assert spec.sid not in self.handles, f"duplicate sid {spec.sid}"
        assert spec.sid >= 0, "negative sids are reserved (warm-up)"
        sc = self.cfg.arrival_scale
        h = StreamHandle(self, spec)
        self.handles[spec.sid] = h
        self._order.append(spec.sid)
        self._push(spec.arrival * sc, "arrival", spec.sid)
        self._pending_arrivals += 1
        for st in spec.switches:
            self._push((spec.arrival + st) * sc, "prompt_switch", spec.sid)
        for (ps, dur) in spec.pauses:
            self._push((spec.arrival + ps) * sc, "pause",
                       (spec.sid, dur * sc))
        return h

    def _push(self, t: float, kind: str, payload: Any) -> None:
        heapq.heappush(self._events, (t, next(self._eseq), kind, payload))

    # ---- clock -------------------------------------------------------------
    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0

    def _calibrate_bundles(self, time_scale: float) -> None:
        """Per-bundle warm-up: every further co-served model measures its
        own top-fidelity chunk on lane 0, seeds its lanes' EMAs and
        carries its own wall <-> profile time scale (a heavy model must
        not inherit a light model's budget conversion); the playout
        cadence fits the slowest model's top-fidelity chunk."""
        self.bundles[0].top_latency = self.top_latency
        self.bundles[0].time_scale = time_scale
        for b in self.bundles[1:]:
            bex = self.lanes.bundle_executors[b.name][0]
            bex.admit(-1, seed=999)
            bex.begin_chunk(-1, HIGHEST_QUALITY, 0.0)
            while -1 in bex.inflight:
                bex.run_step([-1])
            b.top_latency = bex.latency_ema[HIGHEST_QUALITY.key]
            bex.retire(-1, drop_history=True)
            bstep = b.top_latency / (HIGHEST_QUALITY.steps + 1)
            for lex in self.lanes.bundle_executors[b.name]:
                lex.latency_ema[HIGHEST_QUALITY.key] = b.top_latency
                lex.step_ema[HIGHEST_QUALITY.key] = bstep
            b.time_scale = (b.profile.latency(HIGHEST_QUALITY)
                            / max(b.top_latency, 1e-9))
        self.chunk_seconds = (
            self.cfg.realtime_budget
            or self.cfg.budget_factor
            * max(b.top_latency for b in self.bundles))

    # ---- event handlers (mirroring the simulator) --------------------------
    def _bundle_for(self, sid: int):
        """The stream's model bundle (None on single-model sessions); a
        spec without a model rides the session primary."""
        if self.bundles is None:
            return None
        spec_model = getattr(self.handles[sid].spec, "model", None)
        if spec_model is None:
            return self.bundles[0]
        name = self._model_alias.get(spec_model)
        if name is None:
            raise KeyError(
                f"stream {sid} wants model {spec_model!r}, not in the "
                f"co-serve set {[b.name for b in self.bundles]}")
        return next(b for b in self.bundles if b.name == name)

    def _first_estimate(self, sid: int) -> float:
        b = self._bundle_for(sid)
        if b is None:
            return self.lanes.latency_ema_get(HIGHEST_QUALITY.key,
                                              self.top_latency)
        return self.lanes.latency_ema_get(HIGHEST_QUALITY.key,
                                          b.top_latency, model=b.name)

    def _on_arrival(self, sid: int, t_arr: float) -> None:
        self._pending_arrivals -= 1
        first_est = self._first_estimate(sid)
        if self.front_door is not None:
            dec = self.front_door.on_arrival(self.view, t_arr,
                                             first_est, sid)
            if dec.action == "reject":
                self._n_rejected += 1
                return
            if dec.action == "queue":
                return         # promoted by _drain_front_door (or shed)
        self._admit_stream(sid, t_arr, first_est)

    def _admit_stream(self, sid: int, t_arr: float,
                      first_est: float) -> None:
        """Place an admitted stream (``t_arr`` is the ORIGINAL arrival:
        a front-door queue wait consumes the stream's TTFC slack)."""
        spec = self.handles[sid].spec
        ttfc_slack = self.control.initial_slack(first_est)
        home = self.control.choose_home(self.view)
        bundle = self._bundle_for(sid)
        s = Stream(sid=sid, arrival=t_arr, target_chunks=spec.chunks,
                   chunk_seconds=self.chunk_seconds, home=home,
                   ttfc_slack=ttfc_slack,
                   next_deadline=t_arr + ttfc_slack)
        s.t_next = first_est
        model = bundle.name if bundle is not None else None
        s.model = model
        self.view.streams[sid] = s
        self.workers[home].queue.append(sid)
        self.lanes.admit(
            sid, home, seed=sid, streams=self.view.streams,
            protect=list(self.lanes.ex_for(home, model).inflight),
            model=model)

    def _on_prompt_switch(self, sid: int, now: float) -> None:
        s = self.view.streams.get(sid)
        if s is None or s.done:
            return
        # chunks buffered under the old condition are useless: playout
        # slack resets to the initial TTFC and the in-flight chunk is
        # aborted at the next step boundary
        s.next_deadline = now + s.ttfc_slack
        s.step_done = 0
        s.remaining = 0.0
        self.lanes.abort_chunk(sid)
        if s.sp_donor is not None:
            # the donor's mirror holds the OLD prompt's KV: release the
            # borrow before resetting (SP re-triggers if the stream is
            # still behind under the new prompt)
            self._pending_sp_release.pop(sid, None)
            elastic_sp.apply_release(
                self.view, SPDecision(sid, s.sp_donor, "release"))
            self.lanes.sp_release(sid)
        # fresh conditioning: re-encode and rewrite the sink page
        self._switches[sid] = self._switches.get(sid, 0) + 1
        self.lanes.reset_condition(sid, seed=self.switch_seed(sid))

    def switch_seed(self, sid: int) -> int:
        """Conditioning seed of a stream's CURRENT prompt: the admission
        seed (= sid) before any switch, then a deterministic fresh seed
        per switch."""
        n = self._switches.get(sid, 0)
        return sid if n == 0 else sid + 100003 * n

    def _on_pause(self, payload: Tuple[int, float]) -> None:
        sid, dur = payload
        s = self.view.streams.get(sid)
        if s is None or s.done:
            return
        s.next_deadline += dur                 # playout halts; slack grows

    def _drain_events(self, now: float) -> None:
        while self._events and self._events[0][0] <= now:
            t, _, kind, payload = heapq.heappop(self._events)
            if kind == "arrival":
                self._on_arrival(payload, t)
            elif kind == "prompt_switch":
                self._on_prompt_switch(payload, now)
            elif kind == "pause":
                self._on_pause(payload)

    def _drain_front_door(self, now: float) -> None:
        admits, rejects = self.front_door.drain(self.view, now)
        self._n_rejected += len(rejects)
        for sid, t_arr in admits:
            self._admit_stream(sid, t_arr, self._first_estimate(sid))

    # ---- the session loop --------------------------------------------------
    def _all_done(self) -> bool:
        return (self._pending_arrivals == 0
                and (self.front_door is None
                     or not self.front_door.waiting)
                and all(s.done for s in self.view.streams.values()))

    def _sample_tiers(self) -> None:
        counts = queues.tier_counts(self.view)
        cls = [queues.worker_class(counts[w.wid]) for w in self.view.workers]
        self.worker_tier_samples.append(
            (cls.count("urgent"), cls.count("mixed"), cls.count("relaxed")))

    def run(self) -> SessionResult:
        """Drive every submitted stream to completion (or starvation
        stand-still) and return the session's metrics record."""
        while not self._all_done():
            with trace.span("session.schedule"):
                now = self._now()
                self._schedule(now)
            any_ran, any_runnable = self._dispatch_round(now)
            if any_ran:
                continue
            if any_runnable:
                # runnable streams, but none could be made page-resident
                # this round (all victims mid-chunk): defer one beat
                if not self.lanes.any_inflight():
                    if self._events:
                        self._wait_for(self._events[0][0])
                        continue
                    break      # no residency, no work: stand-still
                with trace.span("session.idle"):
                    time.sleep(0.0005)
                continue
            if self._events:
                self._wait_for(self._events[0][0])
                continue
            if self.front_door is not None and self.front_door.waiting:
                with trace.span("session.idle"):
                    time.sleep(0.005)
                continue
            break                                # nothing left to serve
        return self.result()

    def _schedule(self, now: float) -> None:
        """Between rounds: arrivals and stream events, then the control
        tick or, between ticks, the credit order."""
        self._drain_events(now)
        if self.front_door is not None and self.front_door.waiting:
            self._drain_front_door(now)

        # Algorithm 2 control tick: BMPR fidelity -> Eq. 1 credit ->
        # three-tier queue ordering.  R_u comes from the executor's
        # measured step EMAs first so the tick sees honest remaining
        # times.
        for s in self.view.active_streams():
            s.remaining = self.lanes.remaining_estimate(s.sid)
            if self.lanes.is_inflight(s.sid):
                lane = self.lanes.lane_of.get(s.sid, 0)
                link = self.lanes.sp_link(s.sid)
                s.running_on = ((lane, link.donor) if link is not None
                                else (lane,))
            else:
                s.running_on = None
        if now >= self._next_tick:
            decisions = self.control.tick(self.view, now)
            self._apply_decisions(decisions)
            self._sample_tiers()
            self._next_tick = now + self.cfg.tick_interval
        else:
            # between ticks the queues keep tracking credit at step
            # boundaries, exactly like the simulator policy's order()
            for s in self.view.active_streams():
                slack.update_stream_credit(s, now,
                                           self.control.config.alpha)
            queues.order_all(self.view)

    def _dispatch_round(self, now: float) -> Tuple[bool, bool]:
        """One step round over every lane: each lane advances at most
        one micro-batch (or one solo SP2 stream, which also consumes its
        donor lane's slot) by one denoise step.  Returns (any step ran,
        any lane had runnable streams).

        Traced as ``session.round`` with its counters
        (``profiler/trace.py``)."""
        with trace.span("session.round") as span:
            return self._round(now, span)

    def _round(self, now: float, span: Optional[trace.Span]
               ) -> Tuple[bool, bool]:
        streams = self.view.streams
        runnables = {w.wid: queues.next_dispatch_set(w, streams, now)
                     for w in self.view.workers}

        # batch-axis SP rerouting: a stream whose link is mode "batch" is
        # served ON ITS DONOR lane as an extra row of the donor's own
        # micro-batch — it leaves its home lane's runnable list and never
        # consumes a solo dispatch slot
        guests: Dict[int, List[int]] = {}
        for w in self.view.workers:
            kept: List[int] = []
            for sid in runnables[w.wid]:
                link = self.lanes.sp_link(sid)
                if link is not None and link.mode == "batch":
                    guests.setdefault(link.donor, []).append(sid)
                else:
                    kept.append(sid)
            runnables[w.wid] = kept

        # elastic SP2 reservation happens BEFORE any lane serves, so a
        # donor's step slot is genuinely consumed whatever the lane
        # order.  Only a linked stream at the HEAD of its lane's credit
        # order that can run NOW reserves; linked streams deeper in the
        # queue — or whose donor is already committed — fold into the
        # normal micro-batch on the SP1 step (the home pool holds full
        # heads, so SP is an acceleration, never a correctness
        # dependency; the donor mirror keeps appending either way)
        sp_homes: Dict[int, int] = {}      # home wid -> linked sid
        lent: set = set()                  # donor wids, slot lent out
        for w in self.view.workers:
            r = runnables[w.wid]
            if not r or w.wid in lent:
                continue
            link = self.lanes.sp_link(r[0])
            if (link is not None and link.donor != w.wid
                    and link.donor not in lent
                    and link.donor not in sp_homes
                    and self.lanes.ex_for(
                        w.wid, self.lanes.model_of.get(r[0]))
                    .ensure_resident(r[0], streams, protect=[r[0]])):
                sp_homes[w.wid] = r[0]
                lent.add(link.donor)

        any_ran = False
        any_runnable = False
        # per lane: runnable streams (capped at the micro-batch), streams
        # admitted to it, launches
        n_runnable: List[int] = []
        n_admitted: List[int] = []
        n_launched: List[int] = []
        rows = refused = 0
        for w in self.view.workers:
            runnable = runnables[w.wid]
            glist = guests.get(w.wid, [])
            if not runnable and not glist:
                continue
            any_runnable = True
            if w.wid in lent:
                continue       # step slot lent to another lane's SP2
            ex = self.lanes.ex(w.wid)

            # the stream's own bundle's executor on THIS lane (the lane's
            # executor itself on single-model sessions)
            def ex_of(sid: int, lane: int = w.wid) -> Any:
                return self.lanes.ex_for(lane, self.lanes.model_of.get(sid))

            sp_sid = sp_homes.get(w.wid)
            if sp_sid is not None:       # reserved (and already resident)
                sp_ex = ex_of(sp_sid)
                self._begin_if_needed(sp_ex, sp_sid, now)
                flights = {sp_sid: sp_ex.inflight[sp_sid]}
                before = getattr(sp_ex, "dispatch_count", None)
                completed, _ = sp_ex.run_step([sp_sid], sp_serve=True)
                any_ran = True
                now = self._now()
                launched = before is None or sp_ex.dispatch_count > before
                n_runnable.append(1)
                n_admitted.append(1)
                n_launched.append(int(launched))
                rows += int(launched)
                for sid in completed:
                    f = flights[sid]
                    self._complete_chunk(sid, f.fidelity, f.started, now,
                                         f.active_s)
                continue
            # the sequential executor (no page pool) serves one stream
            # per step
            max_batch = self.cfg.max_batch if hasattr(ex, "pool") else 1
            # page-granular admission control: fill the micro-batch from
            # the credit-ordered runnable set with streams that are — or
            # can be made — page-resident (credit-aware eviction); a
            # stream that cannot displace anyone defers one iteration.
            # Batch-axis guests ride ON TOP of max_batch (their donor
            # pages are resident and eviction-protected)
            sids: List[int] = list(glist)
            with trace.span("session.residency") as res:
                moves = self._residency_counts() if res is not None else None
                lane_refused = 0
                for sid in runnable:
                    if len(sids) >= max_batch + len(glist):
                        break
                    if ex_of(sid).ensure_resident(sid, streams,
                                                  protect=sids + [sid]):
                        sids.append(sid)
                    else:
                        lane_refused += 1
                refused += lane_refused
                if res is not None:
                    res.attrs.update(zip(
                        ("evictions", "restores", "deferrals"),
                        (b - a for a, b in zip(
                            moves, self._residency_counts()))))
                    res.attrs["refused"] = lane_refused
            n_runnable.append(len(glist) + min(len(runnable), max_batch))
            n_admitted.append(len(sids))
            n_launched.append(0)
            if not sids:
                continue
            for sid in sids:
                self._begin_if_needed(ex_of(sid), sid, now)
            groups = compose_batch(
                sids, lambda sid: ex_of(sid).inflight[sid].fidelity,
                max_batch + len(glist), fuse=self.cfg.fuse_fidelity,
                model_of=(self.lanes.model_of.get
                          if self.lanes.bundle_executors else None))
            for grp in groups:
                # one sub-batch = one model's step on one pool
                grp_ex = ex_of(grp[0])
                flights = {sid: grp_ex.inflight[sid] for sid in grp}
                before = getattr(grp_ex, "dispatch_count", None)
                completed, _ = grp_ex.run_step(grp)
                any_ran = True
                now = self._now()
                if before is None or grp_ex.dispatch_count > before:
                    n_launched[-1] += 1
                    rows += len(grp)
                for sid in completed:
                    f = flights[sid]
                    self._complete_chunk(sid, f.fidelity, f.started, now,
                                         f.active_s)
        rec = trace.active()
        if span is not None and rec is not None:
            launches = sum(n_launched)
            span.attrs.update(runnable=n_runnable, admitted=n_admitted,
                              launches=launches)
            c = rec.counters
            c["rounds"] += 1
            c["launches"] += launches
            c["split_launches"] += sum(max(n - 1, 0) for n in n_launched)
            c["rows"] += rows
            c["runnable"] += sum(n_runnable)
            c["residency_refused"] += refused
        return any_ran, any_runnable

    def _residency_counts(self) -> Tuple[int, int, int]:
        """Evictions, restores and deferrals over every executor."""
        exs = self.lanes.all_executors
        return tuple(sum(getattr(ex, k, 0) for ex in exs)
                     for k in ("evictions", "restores", "deferrals"))

    def _begin_if_needed(self, ex: Any, sid: int, now: float) -> None:
        if sid in ex.inflight:
            return
        s = self.view.streams[sid]
        # Eq. 1 (paper SS3.2): the fidelity budget at a chunk boundary is
        # B = max(P_u - R_u, 0); R_u = 0 here because the stream is
        # between chunks.  The wall->profile unit conversion lives in
        # _HostCalibratedPolicy.
        with trace.span("session.begin_chunk") as span:
            budget = max(s.playout_slack(now) - s.remaining, 0.0)
            pol = self.control.fidelity_policy
            sel = getattr(pol, "select_for", None)
            dec = (sel(s.model, budget)
                   if sel is not None and s.model is not None
                   else pol.select(budget))
            s.next_fidelity = dec.fidelity
            s.t_next = dec.latency
            s.chunk_started = now
            s.step_done = 0
            ex.begin_chunk(sid, dec.fidelity, now)
            rec = trace.active()
            if span is not None and rec is not None:
                choice = dict(tier=s.tier.name, budget=budget,
                              fidelity=dec.fidelity.key)
                span.attrs.update(sid=sid, predicted=dec.latency, **choice)
                rec.begun[sid] = choice

    # ---- decision apply (the simulator's policy.on_tick equivalent) --------
    def _apply_decisions(self, decisions: TickDecisions) -> None:
        """Execute the tick's cross-worker decisions against the lane
        pool.  An apply can fail (state moved since planning — e.g. a
        full donor pool with nothing evictable); the decision is then
        dropped and the planner re-evaluates next tick."""
        for mig in decisions.migrations:
            if self.lanes.migrate(mig.sid, mig.src, mig.dst,
                                  cross_node=mig.cross_node):
                rehoming.apply_migration(self.view, mig)
        # a donor whose release had to be DEFERRED (its stream is
        # mid-chunk) is still physically borrowed until that boundary —
        # the planner's same-tick rejoin must not re-grant it, or the
        # deferred apply_release would later clear the NEW borrower's
        # donated_to mark (releases precede expands in the plan, so one
        # pass suffices)
        deferred_donors: set = set()
        for dec in decisions.sp_decisions:
            if dec.kind == "expand":
                if dec.donor in deferred_donors:
                    continue
                if self.lanes.sp_expand(dec.sid, dec.donor,
                                        self.view.streams):
                    elastic_sp.apply_expand(self.view, dec)
            elif self.lanes.is_inflight(dec.sid):
                # released at the next safe boundary (chunk completion):
                # the in-flight chunk's head-split step still reads the
                # donor pool
                self._pending_sp_release[dec.sid] = dec.donor
                deferred_donors.add(dec.donor)
            else:
                elastic_sp.apply_release(self.view, dec)
                self.lanes.sp_release(dec.sid)

    # ---- playout bookkeeping (the single per-stream record) ----------------
    def _complete_chunk(self, sid: int, fid: FidelityConfig,
                        started: float, now: float,
                        active_s: float = 0.0) -> None:
        """Playout bookkeeping of a chunk ready at ``now`` (begun at
        ``started``; ``active_s`` seconds in steps).  Traced as
        ``session.complete_chunk`` and one chunk record."""
        rec = trace.active()
        t_span = time.perf_counter() if rec is not None else 0.0
        s = self.view.streams[sid]
        # the chunk became runnable when its predecessor was ready, or
        # when the stream arrived
        runnable = s.ready_times[-1] if s.ready_times else s.arrival
        ddl = s.next_deadline
        s.ready_times.append(now)
        s.deadlines.append(ddl)
        if s.first_chunk_time is None:
            s.first_chunk_time = now
        if now > ddl:
            s.stall_time += now - ddl
            s.stall_events.append(now - ddl)
        s.next_deadline = max(ddl, now) + s.chunk_seconds
        s.chunks_done += 1
        s.step_done = 0
        s.chunk_started = None
        s.running_on = None
        s.remaining = 0.0
        prof = (self._bundle_profiles.get(s.model, self._profile)
                if s.model is not None else self._profile)
        s.qualities.append(prof.quality(fid))
        s.fidelity_log.append(fid.key)
        self.fidelity_counts[fid.key] = \
            self.fidelity_counts.get(fid.key, 0) + 1
        if self.front_door is not None:
            self.front_door.observe_chunk(now - started,
                                          fidelity=fid.key, model=s.model)
        donor = self._pending_sp_release.pop(sid, None)
        if donor is not None and not s.finished:
            # the promised safe boundary: drop the borrow now
            elastic_sp.apply_release(
                self.view, SPDecision(sid, donor, "release"))
            self.lanes.sp_release(sid)
        if s.finished:
            # free the pages NOW: a finished stream's KV would otherwise
            # pin residency (generated chunks survive retire)
            s.done = True
            if s.sp_donor is not None:
                elastic_sp.apply_release(
                    self.view, SPDecision(sid, s.sp_donor, "release"))
            self.lanes.retire(sid)               # releases any SP link
            wq = self.workers[s.home].queue
            if sid in wq:
                wq.remove(sid)
        if self.cfg.verbose:
            print(f"t={now:6.2f}s stream {sid} chunk "
                  f"{s.chunks_done}/{s.target_chunks} "
                  f"fid={fid.key:22s} lat={now - started:.2f}s "
                  f"{'LATE' if now > ddl else 'on-time'}")
        if rec is not None:
            rec.add_span("session.complete_chunk", t_span,
                         time.perf_counter(), sid=sid, lateness=now - ddl)
            choice = rec.begun.pop(sid, {})
            rec.chunks.append(dict(
                sid=sid, tier=choice.get("tier"), fidelity=fid.key,
                budget=choice.get("budget"), runnable=self._t0 + runnable,
                begin=self._t0 + started, ready=self._t0 + now,
                active_s=active_s))

    def _wait_for(self, t_event: float) -> None:
        """Idle until the next workload event (capped nap)."""
        now = self._now()
        with trace.span("session.idle"):
            time.sleep(max(0.0005, min(t_event - now, 0.05)))

    # ---- results -----------------------------------------------------------
    def result(self) -> SessionResult:
        eff_w: Dict[int, List[int]] = {}
        hits = misses = skipped = 0
        for ex in self.lanes.all_executors:
            for sid, log in getattr(ex, "effective_window_log",
                                    {}).items():
                if sid >= 0 and log:
                    eff_w.setdefault(sid, []).extend(log)
            sc = getattr(ex, "stepcache", None)
            if sc is not None:
                hits += sc.hits
                misses += sc.misses
            skipped += getattr(ex, "cache_skipped_launches", 0)
        # step-cache counters summed across lanes; empty when no
        # cache-on chunk ran
        cache_stats: Dict[str, float] = {}
        if hits or misses:
            cache_stats = {"hits": hits, "misses": misses,
                           "hit_rate": hits / (hits + misses),
                           "skipped_launches": skipped}
        return SessionResult(
            streams=dict(self.view.streams), engine=self.lanes.engine,
            n_rehomings=self.control.n_rehomings,
            n_sp_events=self.control.n_sp_events,
            worker_tier_samples=list(self.worker_tier_samples),
            fidelity_counts=dict(self.fidelity_counts),
            control_tick_times=list(self.control.tick_times),
            n_migrations_applied=self.lanes.n_migrations,
            n_sp_expands_applied=self.lanes.n_sp_expands,
            n_sp_releases_applied=self.lanes.n_sp_releases,
            admission=self.front_door.stats() if self.front_door else {},
            effective_window=eff_w, step_cache=cache_stats)

    def _served_stream(self, sid: int) -> ServedStream:
        """Back-compat view assembled FROM the per-stream record."""
        r = self.view.streams.get(sid)
        spec = self.handles[sid].spec
        # the sequential executor keeps each stream's cond and cache
        base = getattr(self.lanes.executor_of(sid), "streams", {}).get(sid)
        return ServedStream(
            sid=sid, cond=getattr(base, "cond", None),
            cache=getattr(base, "cache", None),
            target_chunks=r.target_chunks if r else spec.chunks,
            chunks=list(self.lanes.chunks_of(sid)),
            fidelity_log=list(r.fidelity_log) if r else [],
            next_deadline=r.next_deadline if r else 0.0,
            chunk_seconds=r.chunk_seconds if r else self.chunk_seconds)

    def served_streams(self) -> List[ServedStream]:
        """All submitted streams as ``ServedStream``s, submission order."""
        return [self._served_stream(sid) for sid in self._order]
