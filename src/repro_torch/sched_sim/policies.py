"""Serving policies: SlackServe (real control plane) + SS7.1 baselines.

    SlackServePolicy   wraps repro_torch.core.control_plane (the paper system);
                       ablation switches map to Fig. 12's increments
    SDV2Policy         StreamDiffusionV2-style: FIFO + lockstep batching,
                       fixed fidelity, FPS-oriented, slack-blind
    TSPolicy           TridentServe-style: per-STREAM SLO, dynamic
                       parallelism + load-based migration, static fidelity
    TSChunkPolicy      TS + per-CHUNK least-slack-first scheduling (the
                       paper's strongest external baseline)
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core import elastic_sp, rehoming, slack
from repro_torch.core.bmpr import BMPR, FixedLevelSwitcher, StaticFidelity
from repro_torch.core.control_plane import ControlConfig, ControlPlane
from repro_torch.core.fidelity import FidelityConfig, HIGHEST_QUALITY
from repro_torch.core.types import Stream, Tier, Worker
from repro_torch.profiler.profiles import get_profile
from repro_torch.sched_sim import cost_model as cm
from repro_torch.sched_sim.simulator import Policy, Simulator


class SlackServePolicy(Policy):
    """The paper's system; ablation flags reproduce Fig. 12's increments."""

    def __init__(self, *, use_bmpr: bool = True, use_rehoming: bool = True,
                 use_elastic_sp: bool = True, fidelity_policy=None,
                 alpha: float = 2.0, model: str = "causal-forcing",
                 profile=None):
        self.name = "slackserve"
        # an injected profile (e.g. a CalibratedProfile from the
        # sim-vs-real fitting loop) replaces the analytic surface for
        # BOTH fidelity selection and latency estimates
        self.profile = profile or get_profile(model)
        if fidelity_policy is None:
            fidelity_policy = (BMPR(self.profile) if use_bmpr
                               else StaticFidelity(profile=self.profile))
        self.control = ControlPlane(
            ControlConfig(alpha=alpha, use_rehoming=use_rehoming,
                          use_elastic_sp=use_elastic_sp),
            fidelity_policy=fidelity_policy)

    def attach(self, sim: Simulator) -> None:
        super().attach(sim)
        # the simulator's vectorization flag drives the control tick's
        # numpy path (bit-identical; benchmarks flip it off to measure
        # the scalar baseline)
        self.control.config.vectorized = sim.cfg.vectorized

    # --- admission ---
    def first_chunk_estimate(self) -> float:
        return self.profile.latency(HIGHEST_QUALITY)

    def initial_slack(self, first_est: float) -> float:
        return self.control.initial_slack(first_est)

    def choose_home(self) -> int:
        return self.control.choose_home(self.sim.view)

    # --- control tick (Algorithm 2) ---
    def on_tick(self, now: float) -> None:
        decisions = self.control.tick(self.sim.view, now)
        if decisions.scale_out:
            self.sim.scale_out(decisions.scale_out)
        if decisions.scale_in:
            self.sim.scale_in(decisions.scale_in)
        for mig in decisions.migrations:
            rehoming.apply_migration(self.sim.view, mig)
            self.sim.migrate(mig.sid, mig.src, mig.dst, mig.cross_node)
        for dec in decisions.sp_decisions:
            if dec.kind == "expand":
                elastic_sp.apply_expand(self.sim.view, dec)
                self.sim.sp_head_partition_transfer(dec.sid, dec.donor)
            else:
                elastic_sp.apply_release(self.sim.view, dec)

    @property
    def n_rehomings(self) -> int:
        return self.control.n_rehomings

    @property
    def n_sp_events(self) -> int:
        return self.control.n_sp_events

    @property
    def tick_times(self):
        return self.control.tick_times

    # --- boundaries ---
    def order(self, worker: Worker) -> None:
        """Credit order with continuation hysteresis: a mid-chunk stream
        keeps the worker unless a queued stream is meaningfully more
        urgent (> half a chunk of credit), avoiding EDF-style mid-chunk
        thrash while preserving step-boundary preemption (SS4.1)."""
        streams = self.sim.view.streams
        if not getattr(self.sim, "_credits_fresh", False):
            # outside a tick's dispatch fan-out the credits are stale;
            # inside it the control tick just refreshed every stream at
            # self.sim.now, so recomputing here would be a no-op scan
            for sid in worker.queue:
                slack.update_stream_credit(streams[sid], self.sim.now,
                                           self.control.config.alpha)
        worker.queue.sort(
            key=lambda sid: streams[sid].credit
            - (0.5 * streams[sid].t_next
               if streams[sid].step_done > 0 else 0.0))

    def select_fidelity(self, s: Stream,
                        now: float) -> Tuple[FidelityConfig, float]:
        """Apply the control decision at the boundary with the freshest
        slack budget (SS3.3: decisions take effect at boundaries)."""
        budget = max(s.playout_slack(now), 0.0)
        dec = self.control.fidelity_policy.select(budget)
        sp = 2 if s.sp_donor is not None else 1
        return dec.fidelity, self.profile.latency(dec.fidelity, sp_degree=sp)


class SDV2Policy(Policy):
    """StreamDiffusionV2-style pipeline+batch serving (SS7.1, Fig. 15).

    The 16 GPUs form 4 pipeline-parallel units of 4 GPUs; each unit
    serves its statically-bound streams FIFO in a lockstep batch at
    fixed fidelity.  Pipelining divides per-step latency by ~2.5
    (bubbles), batching inflates it by ``sdv2_batch_step_factor``:
    aggregate FPS tracks the playout rate while per-stream timeliness
    on crowded units collapses — the paper's imbalance analysis.
    Use ``sim_config()`` for the matching cluster shape.
    """

    batch_size = 8
    pipeline_speedup = 2.2
    gpus_per_unit = 4

    def __init__(self, model: str = "causal-forcing"):
        self.name = "sdv2"
        self.profile = get_profile(model)
        self._rr = 0
        self._static = HIGHEST_QUALITY

    @classmethod
    def sim_config(cls, base: "SimConfig" = None):
        from repro_torch.sched_sim.simulator import SimConfig
        base = base or SimConfig()
        import dataclasses as _dc
        n_units = cm.N_WORKERS // cls.gpus_per_unit
        return _dc.replace(base, n_workers=n_units,
                           workers_per_node=max(1, n_units // 2))

    def first_chunk_estimate(self) -> float:
        return self.profile.latency(self._static)

    def choose_home(self) -> int:
        self._rr = (self._rr + 1) % len(self.sim.view.workers)
        return self._rr

    def order(self, worker: Worker) -> None:
        pass                                    # FIFO

    def select_fidelity(self, s, now):
        return self._static, self.profile.latency(self._static)


class TSPolicy(Policy):
    """TridentServe-style: per-stream SLO control loop (SS7.1/SS7.2).

    Dynamic parallelism reacts to STREAM-level progress (not per-chunk
    slack); every SP reconfiguration costs ``TS_RECONFIG_S`` on the
    stream (SS7.2: reconfiguration inflates TTFC); load-based migration
    balances queue lengths, blind to slack."""

    def __init__(self, model: str = "causal-forcing",
                 chunk_level: bool = False):
        self.name = "ts-chunk" if chunk_level else "ts"
        self.profile = get_profile(model)
        self.chunk_level = chunk_level
        self._static = HIGHEST_QUALITY
        self.n_rehomings = 0
        self.n_sp_events = 0

    def first_chunk_estimate(self) -> float:
        return self.profile.latency(self._static)

    def on_admit(self, s: Stream) -> None:
        # admission-time parallelism planning stalls the first chunk
        self.sim.in_transfer[s.sid] = self.sim.now + cm.TS_RECONFIG_S
        self.sim.push(self.sim.now + cm.TS_RECONFIG_S, "stream_ready",
                      (s.sid, s.home))

    def _behind(self, s: Stream, now: float) -> float:
        """Chunks behind the stream-level SLO trajectory."""
        expected = (now - s.arrival - s.ttfc_slack) / s.chunk_seconds + 1.0
        return expected - s.chunks_done

    def on_tick(self, now: float) -> None:
        view = self.sim.view
        for s in view.active_streams():
            s.t_next = self.profile.latency(
                self._static, sp_degree=2 if s.sp_donor else 1)
            slack.update_stream_credit(s, now)
        # ---- dynamic parallelism ----
        n_donated = sum(1 for w in view.workers if w.donated_to is not None)
        for s in view.active_streams():
            if s.done or s.sid in self.sim.in_transfer:
                continue
            if self.chunk_level:
                expand = s.playout_slack(now) < s.t_next
                release = s.playout_slack(now) > 4.0 * s.t_next
            else:
                expand = self._behind(s, now) > 2.0
                release = self._behind(s, now) < 0.0
            if expand and s.sp_donor is None \
                    and n_donated < len(view.workers) // 4:
                donors = [w for w in view.workers
                          if w.donated_to is None and w.wid != s.home
                          and not self.sim.batch[w.wid]]
                if donors:
                    n_donated += 1
                    donor = min(donors, key=lambda w: w.load())
                    s.sp_donor = donor.wid
                    donor.donated_to = s.sid
                    self.n_sp_events += 1
                    # reconfiguration + KV split cost
                    self.sim.sp_head_partition_transfer(s.sid, donor.wid)
                    self.sim.in_transfer[s.sid] = max(
                        self.sim.in_transfer.get(s.sid, 0.0),
                        now + cm.TS_RECONFIG_S)
            elif release and s.sp_donor is not None:
                view.workers[s.sp_donor].donated_to = None
                s.sp_donor = None
        # ---- load-based migration (slack-blind) ----
        loaded = sorted(view.workers, key=lambda w: w.load())
        if loaded[-1].load() - loaded[0].load() > 2:
            src, dst = loaded[-1], loaded[0]
            movable = [sid for sid in src.queue
                       if view.streams[sid].running_on is None
                       and sid not in self.sim.in_transfer]
            if movable:
                sid = movable[-1]
                s = view.streams[sid]
                src.queue.remove(sid)
                dst.queue.append(sid)
                s.home = dst.wid
                self.n_rehomings += 1
                self.sim.migrate(sid, src.wid, dst.wid,
                                 view.node_of(src.wid) !=
                                 view.node_of(dst.wid))

    def order(self, worker: Worker) -> None:
        if self.chunk_level:
            streams = self.sim.view.streams
            worker.queue.sort(
                key=lambda sid: streams[sid].next_deadline)   # least slack
        # else FIFO

    def select_fidelity(self, s, now):
        sp = 2 if s.sp_donor is not None else 1
        return self._static, self.profile.latency(self._static, sp_degree=sp)


def make_policy(name: str, **kw) -> Policy:
    if name == "slackserve":
        return SlackServePolicy(**kw)
    if name == "sdv2":
        return SDV2Policy(**kw)
    if name == "ts":
        return TSPolicy(**kw)
    if name == "ts-chunk":
        return TSPolicy(chunk_level=True, **kw)
    if name == "credit-only":
        return SlackServePolicy(use_bmpr=False, use_rehoming=False,
                                use_elastic_sp=False, **kw)
    if name == "credit+bmpr":
        return SlackServePolicy(use_rehoming=False, use_elastic_sp=False,
                                **kw)
    if name == "credit+bmpr+rehome":
        return SlackServePolicy(use_elastic_sp=False, **kw)
    if name == "bmpr-fixed-level":
        return SlackServePolicy(
            fidelity_policy=FixedLevelSwitcher(get_profile()), **kw)
    raise ValueError(name)
