"""Fidelity-configuration space (paper SS2.1, SS5, App. A).

Four knobs: denoising steps S in {2,3,4}, attention sparsity rho in
{0,.6,.7,.8,.9}, KV-window W in {1,3,7} chunks, quantization Q in
{FP16, FP8} -> 3*5*3*2 = 90 candidate configurations; (4, 0, 7, FP16)
is the highest-quality reference.

The repo adds a fifth knob the paper doesn't have: the AdaCache-style
step cache (``models/stepcache.py``), ``cache in {off, conservative,
aggressive}``.  ``candidate_space(step_cache=True)`` triples the space
to 270; the default keeps the paper's 90 cache=off points so existing
profiles, frontiers, and calibration baselines are unchanged.
"""
from __future__ import annotations

import itertools
from typing import List

from repro_torch.models.ardit import FidelityConfig, HIGHEST_QUALITY  # noqa: F401

STEPS = (2, 3, 4)
SPARSITIES = (0.0, 0.6, 0.7, 0.8, 0.9)
WINDOWS = (1, 3, 7)
QUANTS = ("bf16", "fp8")
CACHE_LEVELS = ("off", "conservative", "aggressive")


def candidate_space(step_cache: bool = False) -> List[FidelityConfig]:
    """All candidate fidelity configurations: the paper's 90 (App. A),
    or 270 with the step-cache knob unlocked."""
    caches = CACHE_LEVELS if step_cache else ("off",)
    return [FidelityConfig(s, r, w, q, c)
            for s, r, w, q, c in itertools.product(STEPS, SPARSITIES,
                                                   WINDOWS, QUANTS,
                                                   caches)]


assert len(candidate_space()) == 90
assert len(candidate_space(step_cache=True)) == 270
