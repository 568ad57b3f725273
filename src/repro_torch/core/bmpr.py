"""Bi-Modal Pareto Routing (BMPR, paper SS5.2).

Offline: build the empirical latency-quality Pareto frontier over the 90
candidate fidelity configurations and set the global quality floor to the
median quality of all candidates.  Online: given a playout-slack budget B,

    quality mode        argmax quality among {L <= B, Q >= floor}
    speed-recovery mode argmin latency among {Q >= floor}  (may exceed B;
                        resource reallocation (SS4) is the next defense)
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.fidelity import FidelityConfig
from repro_torch.profiler.profiles import ChunkProfile, ModelProfile, get_profile


@dataclasses.dataclass(frozen=True)
class ParetoFrontier:
    points: Tuple[ChunkProfile, ...]      # sorted by latency ascending
    q_floor: float

    def __post_init__(self):
        assert all(self.points[i].latency <= self.points[i + 1].latency
                   for i in range(len(self.points) - 1))


def pareto_frontier(profile: ModelProfile) -> ParetoFrontier:
    """Non-dominated (L, Q) points + median quality floor (SS5.2).

    The sort key is a TOTAL order: equal-(latency, quality) points tie
    toward the lexicographically smallest fidelity key, so the frontier
    is deterministic under any permutation of ``profile.points``
    (a plain ``(latency, -quality)`` sort is stable in input order and
    would let the input permutation pick which of two tied configs
    represents the frontier point)."""
    pts = sorted(profile.points,
                 key=lambda p: (p.latency, -p.quality, p.fidelity.key))
    frontier: List[ChunkProfile] = []
    best_q = float("-inf")
    for p in pts:
        if p.quality > best_q:
            frontier.append(p)
            best_q = p.quality
    q_floor = statistics.median(p.quality for p in profile.points)
    return ParetoFrontier(tuple(frontier), q_floor)


@dataclasses.dataclass(frozen=True)
class BMPRDecision:
    fidelity: FidelityConfig
    latency: float
    quality: float
    mode: str                 # "quality" | "speed-recovery"


class BMPR:
    """Per-chunk fidelity selector with a quality floor."""

    def __init__(self, profile: Optional[ModelProfile] = None,
                 frontier: Optional[ParetoFrontier] = None):
        self.profile = profile or get_profile()
        self.frontier = frontier or pareto_frontier(self.profile)
        # floor-eligible frontier suffix, cached for select_bulk: the
        # frontier is latency-ascending with STRICTLY increasing quality
        # (pareto_frontier appends only on quality improvement), so the
        # Q >= floor points form a suffix and "argmax quality with
        # L <= B" is simply the LAST suffix point with latency <= B.
        self._eligible = tuple(p for p in self.frontier.points
                               if p.quality >= self.frontier.q_floor)
        self._eligible_lats: Optional[object] = None   # lazy np array

    def eligible_points(self) -> Tuple[ChunkProfile, ...]:
        """Floor-eligible frontier points, latency ascending."""
        return self._eligible

    def select_bulk(self, budgets) -> "object":
        """Vectorized ``select`` over an array of budgets: returns the
        index into ``eligible_points()`` per budget.  Exactly equivalent
        to calling ``select`` per budget: ``searchsorted(side='right')-1``
        is the last eligible point with ``latency <= budget`` (quality
        mode); a negative index means no point fits, which ``select``
        resolves as speed-recovery = the min-latency eligible point =
        index 0."""
        import numpy as np
        if self._eligible_lats is None:
            self._eligible_lats = np.array(
                [p.latency for p in self._eligible], dtype=np.float64)
        idx = np.searchsorted(self._eligible_lats, budgets,
                              side="right") - 1
        return np.maximum(idx, 0)

    def select(self, budget: float) -> BMPRDecision:
        floor = self.frontier.q_floor
        eligible = [p for p in self.frontier.points
                    if p.latency <= budget and p.quality >= floor]
        if eligible:
            best = max(eligible, key=lambda p: (p.quality, -p.latency))
            return BMPRDecision(best.fidelity, best.latency, best.quality,
                                "quality")
        # speed-recovery: min-latency point that still meets the floor
        above = [p for p in self.frontier.points if p.quality >= floor]
        best = min(above, key=lambda p: p.latency)
        return BMPRDecision(best.fidelity, best.latency, best.quality,
                            "speed-recovery")


class FixedLevelSwitcher:
    """Ablation baseline (Fig. 16): three frontier configs (fast/medium/
    slow) switched on slack thresholds, no quality floor."""

    def __init__(self, profile: Optional[ModelProfile] = None):
        profile = profile or get_profile()
        f = pareto_frontier(profile).points
        self.fast = f[0]
        self.medium = f[len(f) // 2]
        self.slow = f[-1]

    def select(self, budget: float) -> BMPRDecision:
        for p, name in ((self.slow, "slow"), (self.medium, "medium")):
            if p.latency <= budget:
                return BMPRDecision(p.fidelity, p.latency, p.quality, name)
        p = self.fast
        return BMPRDecision(p.fidelity, p.latency, p.quality, "fast")


class StaticFidelity:
    """Baseline: one config for the whole stream (SDV2/TS-style)."""

    def __init__(self, fidelity: Optional[FidelityConfig] = None,
                 profile: Optional[ModelProfile] = None):
        self.profile = profile or get_profile()
        self.fidelity = fidelity or FidelityConfig()
        self._lat = self.profile.latency(self.fidelity)
        self._q = self.profile.quality(self.fidelity)

    def select(self, budget: float) -> BMPRDecision:
        return BMPRDecision(self.fidelity, self._lat, self._q, "static")
