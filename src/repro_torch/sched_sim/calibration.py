"""Sim-vs-real calibration loop.

The discrete-event simulator prices every mechanism off analytic
constants (``profiler.profiles`` latency surface, ``cost_model`` batch
slope, ``state_plane`` bandwidths).  A real ``StreamingSession`` run
MEASURES the same quantities on this host: per-fidelity chunk-latency
EMAs in each lane executor, per-step EMAs, and — on device-backed
lanes — real device-to-device copy bandwidth in
``engine.measured_stats()``.  This module closes the loop:

    report = fit_session(session)          # after session.run()
    cfg    = report.sim_config(n_workers=session.lanes.n_lanes)
    sim    = Simulator(cfg, same_specs, make_policy(
                 "slackserve", profile=report.profile()))

and the simulator replays the workload on the CALIBRATED surface — the
latency profile corrected per fidelity, the playout budget and
transfer constants as the session experienced them — so the sim's
QoE/TTFC prediction can be held against the real run's inside a pinned
tolerance (``agreement``; the CPU tests gate it).

The fit is deliberately simple and robust: per-config ratios where the
run produced a measurement, one global host-speed scale everywhere
else.  Calibration corrects compute speed; the SP communication model
stays analytic (see ``profiles.CalibratedProfile``).
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Optional

from repro_torch.core.fidelity import HIGHEST_QUALITY
from repro_torch.profiler.profiles import (CalibratedProfile, ModelProfile,
                                     calibrate_profile, get_profile)
from repro_torch.sched_sim import cost_model as cm

# pinned sim-vs-real agreement tolerances (test gate; loose enough for
# shared-runner wall-clock noise, tight enough that a unit bug — e.g.
# uncalibrated latencies off by the host-speed factor — fails hard)
QOE_ABS_TOL = 0.25          # |QoE_sim - QoE_real|, QoE in [0, 1]
TTFC_REL_TOL = 1.0          # |TTFC_sim - TTFC_real| / TTFC_real


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """Fitted cost-model constants of one real run."""
    model: str
    ratios: Dict[str, float]        # fidelity key -> measured / analytic
    scale: float                    # global host-speed correction
    chunk_seconds: float            # playout budget the session served
    bw_intra: float                 # B/s (measured-calibrated if moves ran)
    bw_inter: float
    batch_alpha: Optional[float] = None   # sdv2_batch_step_factor slope
    # step-cache level -> measured on/off latency factor (< 1 = speedup)
    cache_speedups: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def profile(self) -> CalibratedProfile:
        # Replay over the 270-point (cache-unlocked) surface only when
        # the real run actually exercised the step cache — otherwise the
        # sim's BMPR would route over cache points the session never
        # had, breaking apples-to-apples agreement.
        used_cache = bool(self.cache_speedups) or any(
            _cache_level_of(k) for k in self.ratios)
        return calibrate_profile(
            get_profile(self.model, step_cache=used_cache),
            self.ratios, self.scale,
            cache_speedups=self.cache_speedups)

    def sim_config(self, base: Any = None, **overrides: Any) -> Any:
        """A ``SimConfig`` replaying on the calibrated surface."""
        from repro_torch.sched_sim.simulator import SimConfig
        return dataclasses.replace(
            base or SimConfig(),
            model=self.model, profile=self.profile(),
            chunk_seconds=self.chunk_seconds,
            bw_intra=self.bw_intra, bw_inter=self.bw_inter,
            batch_alpha=self.batch_alpha, **overrides)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# FidelityConfig.key appends "_c{level[0]}" only for cache-on configs
_CACHE_SUFFIX = {"_cc": "conservative", "_ca": "aggressive"}


def _cache_level_of(key: str) -> Optional[str]:
    """Cache level of a fidelity key, or None for cache=off keys."""
    return _CACHE_SUFFIX.get(key[-3:])


def fit_cache_speedups(measured: Dict[str, float]) -> Dict[str, float]:
    """Measured per-cache-level latency factors (on/off, < 1 = speedup).

    For every cache-on fidelity key whose cache=off SIBLING was also
    measured in the same run, take the on/off chunk-latency ratio and
    average per level — the real-content counterpart of the analytic
    ``step_cache_latency_factor`` prior, which it replaces in
    ``CalibratedProfile`` fallbacks."""
    per_level: Dict[str, List[float]] = {}
    for key, m_on in measured.items():
        level = _cache_level_of(key)
        if level is None or m_on <= 0.0:
            continue
        m_off = measured.get(key[:-3])
        if m_off and m_off > 0.0:
            per_level.setdefault(level, []).append(m_on / m_off)
    return {lvl: statistics.mean(r) for lvl, r in per_level.items()}


def fit_ratios(measured: Dict[str, float],
               profile: ModelProfile) -> Dict[str, float]:
    """Per-config measured/analytic latency ratios (SP1)."""
    by_key = profile.by_key
    return {key: m / by_key[key].latency
            for key, m in measured.items()
            if key in by_key and m > 0.0 and by_key[key].latency > 0.0}


def fit_batch_alpha(batch_step_times: Dict[int, float]) -> Optional[float]:
    """Fit the lockstep-batch slope of ``sdv2_batch_step_factor``
    (t_b = t_1 * (1 + alpha * (b - 1))) from measured per-row step
    times at batch sizes b.  Needs t_1 plus at least one b > 1 point;
    returns None otherwise.  Alpha is clamped to >= 0 (a measured
    superlinear speedup is noise, not a schedulable resource)."""
    t1 = batch_step_times.get(1)
    if not t1 or t1 <= 0.0:
        return None
    pts = [(b, t) for b, t in batch_step_times.items()
           if b > 1 and t > 0.0]
    if not pts:
        return None
    return max(0.0, statistics.mean(
        (t / t1 - 1.0) / (b - 1) for b, t in pts))


def fit_session(session: Any,
                batch_step_times: Optional[Dict[int, float]] = None,
                model: Optional[str] = None) -> CalibrationReport:
    """Fit a ``CalibrationReport`` from a finished ``StreamingSession``.

    Reads the per-fidelity latency EMAs of every lane executor (mean
    across lanes: same host, same device class), the session's playout
    budget, and the transfer engine's bandwidths (measured moves fold
    into ``engine.bw_intra``; runs without any keep the analytic
    constant).

    Co-serving sessions calibrate per bundle: pass ``model`` (a bundle
    name) to fit from THAT bundle's lane executors and profile — each
    co-served model gets its own report, exactly as if it had run
    solo."""
    profile = getattr(session, "_profile", None) or get_profile()
    executors = session.lanes.executors
    if model is not None:
        bundle_profiles = getattr(session, "_bundle_profiles", {})
        if model in bundle_profiles:
            profile = bundle_profiles[model]
        executors = getattr(session.lanes, "bundle_executors",
                            {}).get(model, executors)
    measured: Dict[str, List[float]] = {}
    for ex in executors:
        for key, val in getattr(ex, "latency_ema", {}).items():
            measured.setdefault(key, []).append(val)
    flat = {key: statistics.mean(vals) for key, vals in measured.items()}
    ratios = fit_ratios(flat, profile)
    top = HIGHEST_QUALITY.key
    scale = (ratios.get(top) or
             (statistics.mean(ratios.values()) if ratios else 1.0))
    engine = session.lanes.engine
    return CalibrationReport(
        model=profile.model, ratios=ratios, scale=scale,
        chunk_seconds=session.chunk_seconds,
        bw_intra=getattr(engine, "bw_intra", cm.BW_INTRA),
        bw_inter=getattr(engine, "bw_inter", cm.BW_INTER),
        batch_alpha=fit_batch_alpha(batch_step_times)
        if batch_step_times else None,
        cache_speedups=fit_cache_speedups(flat))


def agreement(real_summary: Any, sim_summary: Any,
              qoe_tol: float = QOE_ABS_TOL,
              ttfc_rel_tol: float = TTFC_REL_TOL) -> Dict[str, Any]:
    """Sim-vs-real QoE/TTFC agreement under the pinned tolerances.

    Returns a dict with the deltas and an overall ``ok``."""
    qoe_delta = abs(sim_summary.qoe - real_summary.qoe)
    if real_summary.ttfc > 0 and real_summary.ttfc != float("inf"):
        ttfc_rel = (abs(sim_summary.ttfc - real_summary.ttfc)
                    / real_summary.ttfc)
    else:
        ttfc_rel = float("inf")
    return {
        "qoe_real": round(real_summary.qoe, 4),
        "qoe_sim": round(sim_summary.qoe, 4),
        "qoe_delta": round(qoe_delta, 4),
        "qoe_tol": qoe_tol,
        "ttfc_real_s": round(real_summary.ttfc, 4),
        "ttfc_sim_s": round(sim_summary.ttfc, 4),
        "ttfc_rel_err": (round(ttfc_rel, 4)
                         if ttfc_rel != float("inf") else None),
        "ttfc_rel_tol": ttfc_rel_tol,
        "ok": bool(qoe_delta <= qoe_tol and ttfc_rel <= ttfc_rel_tol),
    }
