"""Uniform model API: family -> (init, loss, prefill, decode, cache), the
serving surface of the JAX reference's ``models/registry.py``.

The port has two families: ``ardit`` (the paper's model; served through
``serve/``, so its prefill / decode entries are None, as in the
reference) and ``ssm`` (Mamba-2).  Every other family, the training
losses and the dry-run spec helpers (``input_specs`` / ``cache_specs`` /
``param_specs``) wait for their ROADMAP items and raise
``NotImplementedError`` naming them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig

# ROADMAP "Modules to port", "Waiting": the item each missing part waits for
_TRAINING = "ROADMAP 'Modules to port', Waiting: training"
_FAMILIES = "ROADMAP 'Modules to port', Waiting: the other registry families"


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable                    # (cfg, generator, device) -> params
    loss: Callable                    # (cfg, params, batch) -> scalar
    prefill: Optional[Callable]       # (cfg, params, tokens, **kw)
    decode_step: Optional[Callable]   # (cfg, params, cache, token, pos)
    init_cache: Optional[Callable]    # (cfg, batch, max_len, device)


def _not_ported(what: str, item: str) -> Callable:
    def fn(*_args, **_kwargs):
        raise NotImplementedError(f"{what} is not ported yet ({item})")
    return fn


def get_api(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam == "ssm":
        from repro_torch.models import ssm as M
        return ModelAPI(
            M.init_params, _not_ported("ssm.train_loss", _TRAINING),
            M.prefill, M.decode_step,
            lambda cfg, b, _ml, device="cuda": M.init_state(cfg, b, device))
    if fam == "ardit":
        from repro_torch.models import ardit as M
        return ModelAPI(M.init_params,
                        _not_ported("ardit.train_loss", _TRAINING),
                        None, None, None)
    if fam in ("dense", "moe", "vlm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"model family {fam!r} is not ported yet ({_FAMILIES})")
    raise ValueError(f"unknown family {fam!r}")
