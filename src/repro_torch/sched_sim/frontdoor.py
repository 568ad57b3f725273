"""Fleet front door: SLO-aware admission control + autoscaling.

The control plane (Algorithm 2) decides *placement* among the workers
it has; nothing before this module decided *capacity*.  The front door
sits at arrival time and, per stream, predicts the time-to-first-chunk
(TTFC) the current fleet would deliver, compares it against the TTFC
SLO (the same ``ttfc_factor x first_chunk_estimate`` slack budget that
seeds per-stream playout deadlines), and picks one of four outcomes:

    ADMIT       predicted TTFC slack >= 0: the fleet can serve the
                stream inside its SLO right now.
    SCALE-OUT   slack < 0 but autoscaling has headroom: provision
                ``scale_step`` workers (usable after a cold-start
                delay) and QUEUE the arrival until capacity lands.
    QUEUE       slack < 0, no scale headroom, but the wait is bounded:
                hold the arrival FIFO; its TTFC clock keeps running
                (queueing eats the stream's slack — deliberately).
    REJECT      the queue is full or the stream could no longer meet
                its SLO even if admitted: shed load instead of
                admitting a guaranteed stall.

The TTFC prediction is load-derived, not magic: a stream homed on the
least-loaded worker waits for ~``load`` chunk services before its first
dispatch slot, each costing the observed per-chunk service time (seeded
from the profiled top-fidelity latency, re-estimated online from
completed chunks), plus its own first-chunk generation.

The service estimate is **keyed per (model, fidelity)**: each completed
chunk updates the EMA of its own key, and the fleet-wide expected
service is the observation-weighted mix of the keyed EMAs.  One global
EMA systematically over-predicts on a low-fidelity-heavy fleet — a few
slow high-fidelity completions drag the single estimate far above what
the (mostly cheap) next dispatch slots actually cost, and the door
over-rejects.  The global ``chunk_service_ema`` survives as the
no-observations fallback and stays bit-identical on single-key traffic
(one key's EMA sees exactly the global update sequence).

Deciders emit *decisions*; the caller (discrete-event simulator or the
real ``StreamingSession``) applies them — exactly the control-plane
split used everywhere else in this repo.  ``ControlPlane`` exposes the
hooks: ``attach_front_door`` + ``admission`` per arrival, and the tick
returns the autoscale decision in ``TickDecisions.scale_out``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

SLO_TTFC_FACTOR = 4.0       # SLO = factor x first-chunk estimate (SS3.3)


@dataclasses.dataclass
class FrontDoorConfig:
    """Knobs of the admission/autoscaling layer.

    ``slo_ttfc_factor`` mirrors ``ControlConfig.ttfc_factor``: the TTFC
    SLO is ``factor x first_chunk_estimate``.  ``queue_limit`` bounds
    the FIFO admission queue; ``max_queue_wait`` bounds how long an
    arrival may sit in it before it is shed (timeout reject).
    Autoscaling adds ``scale_step`` workers per decision (cold-start
    ``provision_delay`` seconds before they serve), at most every
    ``scale_cooldown`` seconds, never past ``max_workers``.

    Scale-IN retires ``scale_in_step`` idle workers per decision, at
    most every ``scale_in_cooldown`` seconds, only while the admission
    queue is empty and the surviving fleet's predicted TTFC would stay
    comfortably inside the SLO (``scale_in_slack_factor`` x predicted
    TTFC <= SLO), never below ``min_workers``.  The longer cooldown is
    deliberate hysteresis: provisioning is expensive, so capacity is
    shed far more slowly than it is added."""
    slo_ttfc_factor: float = SLO_TTFC_FACTOR
    queue_limit: int = 512
    max_queue_wait: float = 60.0
    autoscale: bool = True
    max_workers: int = 256
    scale_step: int = 4
    scale_cooldown: float = 9.0
    provision_delay: float = 6.0
    # chunk-service EMA blend (new observation weight)
    ema_decay: float = 0.2
    # scale-in (worker retirement) knobs
    min_workers: int = 1
    scale_in_step: int = 1
    scale_in_cooldown: float = 30.0
    scale_in_slack_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Per-arrival front-door outcome (the caller applies it)."""
    action: str                 # "admit" | "queue" | "reject"
    predicted_ttfc: float       # load-derived TTFC estimate (seconds)
    slack: float                # SLO - predicted_ttfc at decision time
    scale_workers: int = 0      # workers to provision alongside


class FrontDoor:
    """SLO-aware admission + autoscaling state machine.

    One instance per run.  All methods are pure host code — the
    fleet simulator calls them hundreds of thousands of times, so the
    per-arrival path is O(workers) and allocation-free beyond the
    decision record."""

    def __init__(self, config: Optional[FrontDoorConfig] = None,
                 first_chunk_estimate: float = 1.0):
        self.cfg = config or FrontDoorConfig()
        self.first_est = first_chunk_estimate
        self.chunk_service_ema = first_chunk_estimate
        # per-(model, fidelity) service EMAs + observation counts; the
        # expected service is their observation-weighted mix (the
        # traffic the fleet ACTUALLY serves), falling back to the
        # global EMA until the first keyed observation lands
        self._service_emas: Dict[Tuple[Optional[str], Optional[str]],
                                 float] = {}
        self._service_obs: Dict[Tuple[Optional[str], Optional[str]],
                                int] = {}
        # FIFO admission queue: (sid, arrival_time, enqueue_time)
        self.waiting: List[Tuple[int, float, float]] = []
        self._cooldown_until = -1e18
        self._in_cooldown_until = -1e18
        self.outcomes: Dict[int, str] = {}       # sid -> final outcome
        self.n_admitted = 0
        self.n_queued = 0                        # ever queued
        self.n_rejected = 0
        self.n_timeouts = 0                      # rejects from queue wait
        self.n_scale_outs = 0
        self.workers_added = 0
        self.n_scale_ins = 0
        self.workers_retired = 0

    # ------------------------------------------------------------- predict
    def slo_ttfc(self) -> float:
        return self.cfg.slo_ttfc_factor * self.first_est

    def expected_service(self) -> float:
        """Expected per-chunk service of the fleet's CURRENT traffic
        mix: the observation-count-weighted mean of the keyed
        per-(model, fidelity) EMAs.  Falls back to the global
        ``chunk_service_ema`` before any keyed observation exists (and
        equals it exactly under single-key traffic)."""
        if not self._service_obs:
            return self.chunk_service_ema
        total = sum(self._service_obs.values())
        return sum(self._service_emas[k] * n
                   for k, n in self._service_obs.items()) / total

    def predict_ttfc(self, view: Any) -> float:
        """Load-derived TTFC estimate for a stream admitted NOW: homed
        on the least-loaded ACTIVE worker (retired workers take no
        admissions), it waits ~load chunk services for its first
        dispatch slot, then generates its own first chunk."""
        load = min((w.load() for w in view.workers if not w.retired),
                   default=min(w.load() for w in view.workers))
        return load * self.expected_service() + self.first_est

    def observe_chunk(self, service_seconds: float,
                      fidelity: Optional[str] = None,
                      model: Optional[str] = None) -> None:
        """Online re-estimation of the per-chunk service time (dispatch
        wait + generation, as completed chunks actually experienced it).
        Updates the global EMA (the keyless fallback) AND the
        per-(model, fidelity) EMA of the chunk's own key."""
        if service_seconds <= 0.0:
            return
        d = self.cfg.ema_decay
        # a new key seeds from the global EMA's PRE-update value: under
        # single-key traffic the keyed recurrence then reproduces the
        # global one exactly (expected_service == chunk_service_ema,
        # keeping the legacy predictor bit-identical there)
        key = (model, fidelity)
        old = self._service_emas.get(key, self.chunk_service_ema)
        self.chunk_service_ema = ((1.0 - d) * self.chunk_service_ema
                                  + d * service_seconds)
        self._service_emas[key] = (1.0 - d) * old + d * service_seconds
        self._service_obs[key] = self._service_obs.get(key, 0) + 1

    # ------------------------------------------------------------- arrival
    def on_arrival(self, view: Any, now: float, first_est: float,
                   sid: int) -> AdmissionDecision:
        """Admission decision for one arriving stream."""
        self.first_est = first_est
        predicted = self.predict_ttfc(view)
        slack = self.slo_ttfc() - predicted
        if slack >= 0.0 and not self.waiting:
            # FIFO fairness: nobody may jump an existing queue
            self.outcomes[sid] = "admitted"
            self.n_admitted += 1
            return AdmissionDecision("admit", predicted, slack)
        scale = self._maybe_scale(view, now)
        if scale > 0 or len(self.waiting) < self.cfg.queue_limit:
            self.waiting.append((sid, now, now))
            self.outcomes[sid] = "queued"
            self.n_queued += 1
            return AdmissionDecision("queue", predicted, slack,
                                     scale_workers=scale)
        self.outcomes[sid] = "rejected"
        self.n_rejected += 1
        return AdmissionDecision("reject", predicted, slack)

    # ------------------------------------------------------------- queue
    def drain(self, view: Any, now: float) -> Tuple[List[Tuple[int, float]],
                                                    List[int]]:
        """Promote / shed queued arrivals.  Returns
        ``(admit, reject)``: ``admit`` is ``[(sid, original_arrival)]``
        in FIFO order, ``reject`` the sids shed on queue timeout.

        A queued stream's TTFC clock runs from its ORIGINAL arrival —
        queueing consumes its slack — so promotion requires the
        *remaining* budget to cover the predicted TTFC."""
        admits: List[Tuple[int, float]] = []
        rejects: List[int] = []
        while self.waiting:
            sid, t_arr, t_enq = self.waiting[0]
            predicted = self.predict_ttfc(view)
            deadline = t_arr + self.slo_ttfc()
            if now + predicted <= deadline:
                self.waiting.pop(0)
                self.outcomes[sid] = "admitted"
                self.n_admitted += 1
                admits.append((sid, t_arr))
                continue
            if now - t_enq > self.cfg.max_queue_wait:
                self.waiting.pop(0)
                self.outcomes[sid] = "rejected"
                self.n_rejected += 1
                self.n_timeouts += 1
                rejects.append(sid)
                continue
            break                        # FIFO head still waiting
        return admits, rejects

    # ------------------------------------------------------------- scaling
    def _maybe_scale(self, view: Any, now: float) -> int:
        cfg = self.cfg
        if not cfg.autoscale or now < self._cooldown_until:
            return 0
        n = sum(1 for w in view.workers if not w.retired)
        if n >= cfg.max_workers:
            return 0
        k = min(cfg.scale_step, cfg.max_workers - n)
        self._cooldown_until = now + cfg.scale_cooldown
        # hysteresis: fresh capacity must not be shed right back
        self._in_cooldown_until = max(self._in_cooldown_until,
                                      now + cfg.scale_in_cooldown)
        self.n_scale_outs += 1
        self.workers_added += k
        return k

    def autoscale(self, view: Any, now: float) -> int:
        """Tick-cadence scale decision: provision when arrivals are
        waiting (the per-arrival path already scaled for the arrival
        that triggered the pressure; this catches sustained backlogs
        across cooldown windows)."""
        if not self.waiting:
            return 0
        return self._maybe_scale(view, now)

    def maybe_scale_in(self, view: Any, now: float) -> int:
        """Tick-cadence scale-IN decision: retire idle workers when the
        admission queue is empty and the survivors' predicted TTFC
        keeps comfortable SLO slack (``scale_in_slack_factor`` margin).
        Only IDLE workers are candidates — the caller drains a victim's
        queued streams by re-homing before marking it retired, so a
        busy fleet simply yields 0 here.  Cooldown-gated with a much
        longer period than scale-out (hysteresis)."""
        cfg = self.cfg
        if (not cfg.autoscale or self.waiting
                or now < self._in_cooldown_until):
            return 0
        active = [w for w in view.workers if not w.retired]
        idle = [w for w in active
                if w.load() == 0 and w.donated_to is None]
        k = min(cfg.scale_in_step, len(idle),
                len(active) - cfg.min_workers)
        if k <= 0:
            return 0
        # survivors' predicted TTFC must stay comfortably positive:
        # retiring k idle workers leaves min-load = the best survivor
        survivors = active[:]
        for w in idle[:k]:
            survivors.remove(w)
        pred = (min(w.load() for w in survivors) * self.expected_service()
                + self.first_est)
        if pred * cfg.scale_in_slack_factor > self.slo_ttfc():
            return 0
        self._in_cooldown_until = now + cfg.scale_in_cooldown
        self.n_scale_ins += 1
        self.workers_retired += k
        return k

    # ------------------------------------------------------------- report
    def stats(self) -> Dict[str, int]:
        return {
            "admitted": self.n_admitted,
            "queued": self.n_queued,
            "rejected": self.n_rejected,
            "queue_timeouts": self.n_timeouts,
            "scale_outs": self.n_scale_outs,
            "workers_added": self.workers_added,
            "scale_ins": self.n_scale_ins,
            "workers_retired": self.workers_retired,
            "waiting_at_end": len(self.waiting),
        }
