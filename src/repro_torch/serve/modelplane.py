"""Model plane: registry-backed bundles for heterogeneous co-serving.

A ``ModelBundle`` is everything the serving stack needs to run streams of
ONE model on a lane pool: the registry config, its params on the
serving device, the uniform :mod:`repro_torch.models.registry` API, the
paged-pool geometry derived from the config, the offline latency /
quality profile, and the relative placement costs (per-chunk step cost,
per-page KV footprint) that let the control plane weigh a cheap stream
against a heavy one when choosing a home.

The serving stack is a map over bundles: ``LanePool`` holds one paged
``KVPool`` + params per bundle per lane, ``compose_batch`` keys
sub-batches by ``(model, kv_dtype)``, and re-homing / elastic SP stay
same-model-only because every source / target executor is resolved
through the stream's bundle.  A single-bundle session builds the same
objects in the same order as a ``model_cfg`` session, so its chunks are
bit-identical to that path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import ardit as A
from repro_torch.models import kvcache
from repro_torch.models.convert import params_to
from repro_torch.models.registry import ModelAPI, get_api
from repro_torch.profiler.profiles import MODEL_COST, ModelProfile, get_profile

# Registry arch id -> profile surface name.  The analytic profile is keyed
# by the paper's model columns; registry ids not listed here use their own
# name (falling through to the default quality ceiling in ``Q_MAX`` and
# the per-model cost prior in ``MODEL_COST``).
PROFILE_NAME: Dict[str, str] = {
    "ardit-self-forcing": "self-forcing",
    "ardit-causal-forcing": "causal-forcing",
}


def profile_name_of(arch: str) -> str:
    return PROFILE_NAME.get(arch, arch)


@dataclasses.dataclass
class ModelBundle:
    """Config + params + profile + pool geometry for one served model."""
    name: str                 # registry arch id (e.g. "ardit-self-forcing")
    cfg: ModelConfig
    api: ModelAPI
    params: Any
    profile: ModelProfile
    # paged-pool geometry (as KVPool derives it; bundles own it so
    # placement can weigh footprints without instantiating a pool)
    page_tokens: int
    pages_per_stream: int
    kv_dtype: str
    # placement weights, relative to the session's primary bundle
    step_cost: float = 1.0    # per-chunk compute multiplier
    page_cost: float = 1.0    # per-page KV bytes multiplier
    # per-model warm-up calibration, filled in by StreamingSession
    top_latency: float = 0.0
    time_scale: float = 1.0

    @property
    def placement_weight(self) -> float:
        """Scalar load weight of one stream of this model: service time
        dominates worker occupancy, residency pressure is secondary,
        ``step_cost * sqrt(page_cost)``.  The primary bundle weighs 1.0,
        so single-model placement is the integer queue-depth argmin."""
        return self.step_cost * float(np.sqrt(self.page_cost))

    @property
    def page_bytes(self) -> int:
        """KV bytes of one page of this bundle's pool (the torch dtype's
        item size: bf16 and e4m3 have no numpy dtype without
        ``ml_dtypes``)."""
        itemsize = A.DTYPES[self.kv_dtype].itemsize
        return (self.cfg.n_layers * self.page_tokens
                * self.cfg.n_kv_heads * self.cfg.head_dim * itemsize)

    @property
    def stream_bytes(self) -> int:
        """KV bytes of one fully-resident stream (sink + ring pages)."""
        return self.pages_per_stream * self.page_bytes


def _pool_geometry(cfg: ModelConfig):
    page_tokens = max(A.COND_TOKENS, A.chunk_tokens(cfg))
    pps = kvcache.pages_per_stream(cfg.ardit_window_chunks)
    return page_tokens, pps


def resolve_bundle(model: Union[str, ModelConfig], *, seed: int = 0,
                   reduced: bool = True, step_cache: bool = False,
                   params: Any = None, device: Any = "cuda") -> ModelBundle:
    """Resolve one registry arch (or explicit config) into a bundle on
    ``device``.  ``params`` (any device) replaces the registry ``init``
    from a ``torch.Generator`` seeded with ``seed``.

    Live serving drives the AR-DiT denoise path, so the config must be
    ``family == "ardit"``; other registry families are co-served only
    in the simulator, through per-model cost priors."""
    if isinstance(model, str):
        cfg = get_config(model)
        if reduced:
            cfg = cfg.reduced()
        arch = model
    else:
        cfg = model
        arch = cfg.name[:-len("-reduced")] \
            if cfg.name.endswith("-reduced") else cfg.name
    if cfg.family != "ardit":
        raise ValueError(
            f"live co-serving requires an ardit-family config, got "
            f"{arch!r} (family {cfg.family!r}); non-ardit models are "
            f"simulated via per-model cost priors instead")
    api = get_api(cfg)
    device = torch.device(device)
    params = (params_to(params, device) if params is not None
              else api.init(cfg, torch.Generator().manual_seed(seed),
                            device))
    page_tokens, pps = _pool_geometry(cfg)
    pname = profile_name_of(arch)
    return ModelBundle(
        name=arch, cfg=cfg, api=api, params=params,
        profile=get_profile(pname, step_cache=step_cache),
        page_tokens=page_tokens, pages_per_stream=pps,
        kv_dtype=cfg.kv_dtype,
        step_cost=MODEL_COST.get(pname, 1.0))


def resolve_bundles(models: Sequence[Union[str, ModelConfig, ModelBundle]],
                    *, seed: int = 0, reduced: bool = True,
                    step_cache: bool = False,
                    device: Any = "cuda") -> List[ModelBundle]:
    """Resolve a co-served model set; weights are normalized so the FIRST
    bundle (the session primary) has step_cost == page_cost == 1.0.  An
    entry that is already a ``ModelBundle`` (e.g. from ``resolve_bundle``
    with given ``params``) is taken as it is."""
    if not models:
        raise ValueError("need at least one model")
    bundles = [m if isinstance(m, ModelBundle)
               else resolve_bundle(m, seed=seed, reduced=reduced,
                                   step_cache=step_cache, device=device)
               for m in models]
    names = [b.name for b in bundles]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate models in co-serve set: {names}")
    # step costs from the cost priors (not from the bundles' current
    # values), so normalizing a given bundle again changes nothing
    cost = [MODEL_COST.get(profile_name_of(b.name), 1.0) for b in bundles]
    ref_page = float(bundles[0].page_bytes) or 1.0
    for b, c in zip(bundles, cost):
        b.step_cost = c / (cost[0] or 1.0)
        b.page_cost = float(b.page_bytes) / ref_page
    return bundles
