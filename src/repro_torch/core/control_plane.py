"""Control Plane (paper SS3.2-3.3, Algorithm 2, App. C.1).

Wakes at each control tick (3 s default) and, in trigger order:

    1. BMPR fidelity selection per active stream (SS5)
    2. service-credit + tier update under the selected fidelity (Eq. 1)
    3. three-tier queue (re)ordering -> local preemption (SS4.1)
    4. bipartite re-homing plan -> cross-worker preemption (SS4.2)
    5. elastic-SP plan -> compute expansion for C_u < 0 (SS4.3)

Every mechanism is individually switchable (technique ablation, Fig. 12).
The Control Plane emits *decisions*; the caller (discrete-event simulator
or JAX executor) applies them and routes state movement through the State
Plane (SS4.4).
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import elastic_sp, queues, rehoming, slack
from repro_torch.core.bmpr import BMPR, BMPRDecision
from repro_torch.core.types import ClusterView, Stream, Tier, Worker

DEFAULT_TICK_S = 3.0
TTFC_FACTOR = 4.0          # initial playout slack = 4x first-chunk estimate


@dataclasses.dataclass
class ControlConfig:
    tick_interval: float = DEFAULT_TICK_S
    alpha: float = slack.DEFAULT_ALPHA
    use_fidelity: bool = True          # BMPR (or injected policy)
    use_rehoming: bool = True
    use_elastic_sp: bool = True
    ttfc_factor: float = TTFC_FACTOR
    # batch the per-stream fidelity/credit/tier updates through numpy
    # (bit-identical to the scalar loop; requires a fidelity policy with
    # ``select_bulk``, else the tick falls back to the scalar loop)
    vectorized: bool = False


@dataclasses.dataclass
class TickDecisions:
    migrations: List[rehoming.Migration]
    sp_decisions: List[elastic_sp.SPDecision]
    control_time_s: float              # wall-clock cost of this tick
    scale_out: int = 0                 # front-door autoscale: workers to add
    scale_in: int = 0                  # front-door scale-in: workers to retire


class ControlPlane:
    def __init__(self, config: Optional[ControlConfig] = None,
                 fidelity_policy=None):
        self.config = config or ControlConfig()
        self.fidelity_policy = fidelity_policy or BMPR()
        self.front_door = None         # optional admission/autoscale layer
        self.n_rehomings = 0
        self.n_sp_events = 0
        self.tick_times: List[float] = []

    # ---- front door (admission + autoscaling, sched_sim.frontdoor) --------
    def attach_front_door(self, front_door) -> None:
        """Attach an SLO-aware admission/autoscaling layer.  Once
        attached, ``admission`` gates every arrival and each tick's
        ``TickDecisions.scale_out`` carries the autoscale decision."""
        self.front_door = front_door

    def admission(self, view: ClusterView, now: float,
                  first_chunk_estimate: float, sid: int):
        """Per-arrival admission decision (``AdmissionDecision``), or
        None when no front door is attached (legacy: always admit)."""
        if self.front_door is None:
            return None
        return self.front_door.on_arrival(view, now,
                                          first_chunk_estimate, sid)

    # ---- admission (SS3.3 steps 1-2) --------------------------------------
    def choose_home(self, view: ClusterView) -> int:
        """Least-loaded worker, excluding SP donors: a worker serving
        someone else's SP2 half has no headroom its own queue shows
        (``Worker.load`` also counts the donation, but an admitted
        stream would still contend with the borrowed one, so donors are
        skipped outright while any non-donating worker exists).
        Retired workers (front-door scale-in) never take admissions.

        With heterogeneous co-serving the view carries ``stream_weight``
        (sid -> per-model placement weight) and the argmin runs over
        weighted load — a worker holding one heavy-model stream is more
        loaded than one holding one cheap stream.  ``stream_weight`` is
        None on single-model paths, where ``load(None)`` is the exact
        integer count."""
        free = [w for w in view.workers
                if w.donated_to is None and not w.retired]
        return min(free or view.workers,
                   key=lambda w: w.load(view.stream_weight)).wid

    def initial_slack(self, first_chunk_estimate: float) -> float:
        return self.config.ttfc_factor * first_chunk_estimate

    # ---- the control tick (Algorithm 2 lines 7-15) ------------------------
    def tick(self, view: ClusterView, now: float) -> TickDecisions:
        t0 = _time.perf_counter()
        cfg = self.config

        if cfg.vectorized and (not cfg.use_fidelity
                               or hasattr(self.fidelity_policy,
                                          "select_bulk")):
            self._update_streams_vectorized(view, now)
        else:
            self._update_streams_scalar(view, now)

        queues.order_all(view)

        # one tier-histogram pass shared by both planners (they plan
        # back-to-back with no mutation in between, so sharing is exact)
        counts = None
        if cfg.use_rehoming or cfg.use_elastic_sp:
            counts = queues.tier_counts(view)

        migrations: List[rehoming.Migration] = []
        if cfg.use_rehoming:
            migrations = rehoming.plan_rehoming(view, now, counts=counts)
            self.n_rehomings += len(migrations)

        sp_decisions: List[elastic_sp.SPDecision] = []
        if cfg.use_elastic_sp:
            just_migrated = {m.sid for m in migrations}
            # vectorized tick: hoist the donor-quality signal (min
            # resident credit per worker) to one pass instead of one
            # scan per (negative stream, candidate donor) pair
            donor_credits = (queues.min_credits(view) if cfg.vectorized
                             else None)
            sp_decisions = elastic_sp.plan_elastic_sp(
                view, now, exclude=just_migrated, counts=counts,
                donor_credits=donor_credits)
            self.n_sp_events += sum(1 for d in sp_decisions
                                    if d.kind == "expand")

        scale_out = 0
        scale_in = 0
        if self.front_door is not None:
            scale_out = self.front_door.autoscale(view, now)
            if scale_out == 0:
                # never shed and add capacity in the same tick
                scale_in = self.front_door.maybe_scale_in(view, now)

        dt = _time.perf_counter() - t0
        self.tick_times.append(dt)
        return TickDecisions(migrations, sp_decisions, dt, scale_out,
                             scale_in)

    def _update_streams_scalar(self, view: ClusterView, now: float) -> None:
        cfg = self.config
        for s in view.active_streams():
            # (3) fidelity selection under the current slack budget
            if cfg.use_fidelity and not s.finished:
                budget = max(s.playout_slack(now)
                             - (s.remaining if s.running_on else 0.0), 0.0)
                # co-serving: route through the stream's model bundle
                # when the policy is model-aware (``select_for``);
                # single-model streams (model None) take the exact
                # legacy call
                sel = getattr(self.fidelity_policy, "select_for", None)
                dec: BMPRDecision = (
                    sel(s.model, budget)
                    if sel is not None and s.model is not None
                    else self.fidelity_policy.select(budget))
                s.next_fidelity = dec.fidelity
                sp = 2 if s.sp_donor is not None else 1
                s.t_next = self.fidelity_policy.profile.latency(
                    dec.fidelity, sp_degree=sp) \
                    if hasattr(self.fidelity_policy, "profile") else dec.latency
            # (4) service credit + tier under the selected fidelity
            slack.update_stream_credit(s, now, cfg.alpha)

    def _update_streams_vectorized(self, view: ClusterView,
                                   now: float) -> None:
        """Numpy-batched equivalent of ``_update_streams_scalar``:
        fidelity via ``select_bulk`` (searchsorted over the eligible
        frontier), then Eq. 1 credit + tier thresholds as array ops.
        Operation order matches the scalar path term-for-term —
        ``(nd - now) - (rem + t_next)`` in float64 — so results are
        bit-identical (asserted by the scalar-vs-vectorized parity
        test)."""
        import math

        import numpy as np
        cfg = self.config
        streams = view.active_streams()
        if not streams:
            return
        n = len(streams)
        nd = np.fromiter((s.next_deadline for s in streams),
                         dtype=np.float64, count=n)
        rem = np.fromiter((s.remaining if s.running_on else 0.0
                           for s in streams), dtype=np.float64, count=n)
        if cfg.use_fidelity:
            fp = self.fidelity_policy
            budgets = np.maximum((nd - now) - rem, 0.0)
            idx = fp.select_bulk(budgets)
            pts = fp.eligible_points()
            prof = getattr(fp, "profile", None)
            # the ``t_next`` setter validates each assignment; the
            # eligible points' latencies are fixed floats, so validate
            # once per point here and write the backing field directly
            # (== profile.latency(fid, sp_degree=1): ChunkProfile
            # latencies come from the same chunk_latency surface)
            fids = tuple(p.fidelity for p in pts)
            lats = tuple(float(p.latency) for p in pts)
            for lat in lats:
                if not (math.isfinite(lat) and lat >= 0.0):
                    raise ValueError(
                        f"frontier latency {lat!r} is not a valid T_u")
            # T_u column built array-side from the selection (finished /
            # SP2 streams corrected below), replacing a second fromiter
            # pass plus a separate per-stream write loop
            tn = np.asarray(lats, dtype=np.float64)[idx]
            idx_l = idx.tolist()
            for i, s in enumerate(streams):
                if s.finished:
                    tn[i] = s._t_next
                elif s.sp_donor is not None and prof is not None:
                    tn[i] = prof.latency(fids[idx_l[i]], sp_degree=2)
        else:
            idx_l = None
            tn = np.fromiter((s.t_next for s in streams),
                             dtype=np.float64, count=n)
        credit = (nd - now) - (rem + tn)
        tier_idx = np.where(credit < cfg.alpha * tn, 0,
                            np.where(credit > 2.0 * cfg.alpha * tn,
                                     2, 1)).tolist()
        tiers = (Tier.URGENT, Tier.NORMAL, Tier.RELAXED)
        if idx_l is not None:
            tn_l = tn.tolist()
            for s, c, t, j, lat in zip(streams, credit.tolist(),
                                       tier_idx, idx_l, tn_l):
                if not s.finished:
                    s.next_fidelity = fids[j]
                    s._t_next = lat
                s.credit = c
                s.tier = tiers[t]
        else:
            for s, c, t in zip(streams, credit.tolist(), tier_idx):
                s.credit = c
                s.tier = tiers[t]
