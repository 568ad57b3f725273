"""Offline profiler: latency / quality surfaces per fidelity configuration.

The paper profiles every candidate configuration offline (App. A): average
per-chunk latency L (ms) and VBench quality Q per config.  On real
hardware this is a measurement pass; in this repo the latency surface is
an analytic cost model calibrated to the paper's operating points (a
Self-Forcing-class 1.3B AR-DiT at 480p generates a 3-latent-frame chunk
in ~0.72 s at the highest-quality config on one H100 — just inside the
16 fps real-time budget of 0.75 s/chunk), and the quality surface is a
deterministic response model reproducing App. A's frontier shape:

    latency(cfg) = S * (t_fixed + t_mlp*q(Q) + t_attn*vis(W)*(1-rho)*q(Q))
    quality(cfg) = q_max - a_S(4-S)^1.6 - a_r*rho^2.5*vis(W)^0.5
                   - a_W*(1 - vis(W))^1.4 - a_Q*[fp8] - interactions

Both surfaces are exposed through ``ModelProfile`` so BMPR (SS5.2), the
service-credit estimator (Eq. 1), and the cluster simulator read one
consistent timing prior — exactly the role the paper's offline profiler
plays.  Constants live here, with their derivations, so swapping in real
measurements is a one-file change.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

from repro_torch.core.fidelity import FidelityConfig, candidate_space

# -- timing constants (seconds), per H100-class worker, 480p, 3-frame chunk --
# Derivation: the highest-quality reference (S=4, rho=0, W=7, bf16)
# lands at 0.72 s/chunk — JUST inside the 0.75 s playout budget, matching
# Self-Forcing's ~17 fps single-GPU rate.  A solo stream is sustainable
# at top fidelity; pressure comes from worker SHARING (two streams on a
# worker run at an effective 1.44 s cadence and bleed ~0.7 s of slack per
# chunk), which is what slack-driven reallocation + BMPR absorb and
# slack-blind baselines do not (Fig. 15's URGENT/RELAXED imbalance).
# Per-step split: fixed overhead 40 ms, MLP+projections 90 ms,
# full-window attention 50 ms; fp8 keeps tensor-core paths ~1.6x faster
# on the quantizable share (SageAttention2 reports 1.6-2.1x).
T_FIXED = 0.040
T_MLP = 0.090
T_ATTN = 0.050
FP8_FACTOR = 0.625
W_MAX = 7

# -- quality constants (VBench points, 0-100) --------------------------------
# q_max matches the paper's reported ~81.1 VBench for Causal-Forcing; knob
# penalties are shaped so the 90-config surface spans ~6 VBench points and
# the median (the paper's global quality floor) sits ~1.2 under q_max.
Q_MAX = {"causal-forcing": 81.3, "self-forcing": 80.9}
A_S = 0.55
A_RHO = 2.6
A_W = 1.1
A_Q = 0.35
A_INT = 0.8          # rho x low-S interaction (fewer steps amplify sparsity)

# -- step cache (AdaCache-style residual reuse, models/stepcache.py) ----------
# Expected fraction of *cacheable* denoise steps (steps 1..S-1 of a
# chunk; step 0 and the clean pass always compute) that reuse the cached
# velocity on generic content.  Conservative allows at most one
# consecutive reuse under a tight residual threshold; aggressive allows
# two under a loose one.  Calibration (``fit_cache_speedups``) replaces
# the analytic factor with measured on/off latency ratios once a real
# session has observed both.  Quality penalties (VBench points) follow
# AdaCache's report that residual-gated reuse costs little on stable
# content; aggressive pays visibly more.
STEP_CACHE_HIT_RATE = {"off": 0.0, "conservative": 0.25, "aggressive": 0.5}
A_CACHE = {"off": 0.0, "conservative": 0.18, "aggressive": 0.5}

# -- per-model step-cost multipliers (heterogeneous co-serving) ---------------
# Relative per-chunk compute vs the Wan-1.3B AR-DiT reference.  The two
# paper columns share that backbone (1.0 — multiplying by 1.0 is skipped,
# keeping single-model latencies bit-identical).  The other registry
# families carry analytic priors from their arithmetic intensity — a
# Mamba-2 scan is cheap per token, a top-k MoE activates a parameter
# slice far larger than a dense 1.3B — consumed by the simulator's
# per-stream step cost and by placement weighting (``Worker.load``),
# never by the live jitted path (which measures its own EMAs).
MODEL_COST: Dict[str, float] = {
    "causal-forcing": 1.0,
    "self-forcing": 1.0,
    "mamba2-780m": 0.35,
    "minicpm-2b": 0.8,
    "granite-moe-1b-a400m": 0.6,
    "minitron-8b": 2.2,
    "internlm2-20b": 4.5,
    "jamba-v0.1-52b": 3.0,
    "internvl2-26b": 5.5,
    "qwen1.5-32b": 6.5,
    "qwen3-moe-235b-a22b": 7.5,
    "whisper-medium": 0.5,
}


def step_cache_latency_factor(level: str, steps: int) -> float:
    """Expected chunk-latency multiplier of a cache level.

    A chunk runs ``steps`` denoise forwards plus one clean forward;
    a hit replaces a whole forward with an O(tokens) AXPY (modeled
    free next to the transformer stack)."""
    h = STEP_CACHE_HIT_RATE[level]
    total = steps + 1
    cacheable = max(steps - 1, 0)
    return (total - h * cacheable) / total


@dataclasses.dataclass(frozen=True)
class ChunkProfile:
    fidelity: FidelityConfig
    latency: float           # seconds per chunk on one worker (SP1)
    quality: float           # VBench points


@functools.lru_cache(maxsize=None)
def chunk_latency(cfg: FidelityConfig, *, sp_degree: int = 1,
                  model: str = "causal-forcing") -> float:
    """Profiled per-chunk generation time (SS2.1: highly profileable).

    Cached: the fleet simulator evaluates this for every denoise-step
    event (hundreds of thousands of calls over a 90-point config space),
    and the surface is pure in (cfg, sp_degree, model)."""
    vis = min(cfg.window, W_MAX) / W_MAX
    qf = FP8_FACTOR if cfg.quant == "fp8" else 1.0
    step = T_FIXED + T_MLP * qf + T_ATTN * vis * (1.0 - cfg.sparsity) * qf
    lat = cfg.steps * step
    if sp_degree > 1:
        # Ulysses SP2: compute halves, all-to-all adds ~12% of the split
        # compute (intra-node NVLink / ICI); fixed overhead not split.
        compute = lat - cfg.steps * T_FIXED
        lat = cfg.steps * T_FIXED + compute / sp_degree * 1.12
    cache = getattr(cfg, "cache", "off")
    if cache != "off":
        lat *= step_cache_latency_factor(cache, cfg.steps)
    cost = MODEL_COST.get(model, 1.0)
    if cost != 1.0:
        lat *= cost
    return lat


def chunk_quality(cfg: FidelityConfig, *,
                  model: str = "causal-forcing") -> float:
    vis = min(cfg.window, W_MAX) / W_MAX
    q = Q_MAX.get(model, 81.0)
    q -= A_S * (4 - cfg.steps) ** 1.6
    q -= A_RHO * (cfg.sparsity ** 2.5) * (vis ** 0.5)
    q -= A_W * (1.0 - vis) ** 1.4
    q -= A_Q * (1.0 if cfg.quant == "fp8" else 0.0)
    q -= A_INT * cfg.sparsity * (4 - cfg.steps) / 2.0
    q -= A_CACHE[getattr(cfg, "cache", "off")]
    return q


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """All 90 profiled points for one AR-DiT model (App. A)."""
    model: str
    points: Tuple[ChunkProfile, ...]

    def latency(self, cfg: FidelityConfig, sp_degree: int = 1) -> float:
        return chunk_latency(cfg, sp_degree=sp_degree, model=self.model)

    def quality(self, cfg: FidelityConfig) -> float:
        return chunk_quality(cfg, model=self.model)

    @property
    def by_key(self) -> Dict[str, ChunkProfile]:
        return {p.fidelity.key: p for p in self.points}


@functools.lru_cache(maxsize=None)
def get_profile(model: str = "causal-forcing",
                step_cache: bool = False) -> ModelProfile:
    """The App. A profile: 90 points, or 270 with the step-cache knob
    unlocked (``step_cache=True`` — BMPR then routes over cache levels
    like any other fidelity axis)."""
    pts = tuple(ChunkProfile(c, chunk_latency(c, model=model),
                             chunk_quality(c, model=model))
                for c in candidate_space(step_cache=step_cache))
    return ModelProfile(model, pts)


@dataclasses.dataclass(frozen=True)
class CalibratedProfile(ModelProfile):
    """Analytic latency surface corrected by MEASURED per-config chunk
    latencies (sim-vs-real calibration, DESIGN.md SS8: swapping in real
    measurements is a one-file change — this is that change, done
    online).

    ``ratios[key]`` multiplies the analytic latency of the fidelity
    config with that key (measured / analytic at SP1); configs the real
    run never executed fall back to the uniform ``scale`` (the
    measured-over-analytic ratio of the top-fidelity config — one global
    host-speed correction).  SP degrees inherit the same ratio: the
    calibration measures host compute speed, and the SP communication
    model stays analytic.

    Step-cache fallback chain: a cache-on key the run never executed
    first tries its cache=off sibling's measured ratio times the fitted
    per-level speedup (``cache_speedups``, from
    ``calibration.fit_cache_speedups``) — or, with no fitted speedup,
    the analytic ``step_cache_latency_factor`` — before the global
    ``scale``."""
    ratios: Dict[str, float] = dataclasses.field(default_factory=dict)
    scale: float = 1.0
    cache_speedups: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def latency(self, cfg: FidelityConfig, sp_degree: int = 1) -> float:
        if cfg.key in self.ratios:
            return chunk_latency(cfg, sp_degree=sp_degree,
                                 model=self.model) * self.ratios[cfg.key]
        cache = getattr(cfg, "cache", "off")
        if cache != "off":
            off = cfg._replace(cache="off")
            if off.key in self.ratios:
                lat_off = chunk_latency(off, sp_degree=sp_degree,
                                        model=self.model) \
                    * self.ratios[off.key]
                factor = self.cache_speedups.get(
                    cache, step_cache_latency_factor(cache, cfg.steps))
                return lat_off * factor
        base = chunk_latency(cfg, sp_degree=sp_degree, model=self.model)
        return base * self.scale


def calibrate_profile(base: ModelProfile, ratios: Dict[str, float],
                      scale: float = 1.0,
                      cache_speedups: Optional[Dict[str, float]] = None,
                      ) -> CalibratedProfile:
    """Build a ``CalibratedProfile`` whose ``points`` (the BMPR frontier
    input) carry the corrected latencies, so fidelity selection and the
    simulator's cost model read ONE calibrated surface."""
    prof = CalibratedProfile(base.model, (), ratios=dict(ratios),
                             scale=scale,
                             cache_speedups=dict(cache_speedups or {}))
    pts = tuple(ChunkProfile(p.fidelity, prof.latency(p.fidelity),
                             p.quality) for p in base.points)
    return dataclasses.replace(prof, points=pts)
