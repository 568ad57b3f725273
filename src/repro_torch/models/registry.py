"""Uniform model API: family -> (init, loss, prefill, decode, cache) plus
the ``input_specs`` / ``cache_specs`` / ``param_specs`` stand-ins of the
JAX reference's ``models/registry.py``.

The stand-ins are tensors on torch's ``meta`` device where the reference
has ``jax.ShapeDtypeStruct``: the same shapes and dtypes, nothing
allocated.  The port serves ``ardit`` (the paper's model; served through
``serve/``, so its prefill / decode entries are None, as in the
reference), ``ssm`` (Mamba-2), ``dense`` / ``moe`` / ``vlm``
(``models/transformer.py``), ``hybrid`` (``models/hybrid.py``) and
``encdec`` (``models/encdec.py``, whisper-medium); every family's
``loss`` is its ``train_loss``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable                    # (cfg, generator, device) -> params
    loss: Callable                    # (cfg, params, batch) -> scalar
    prefill: Optional[Callable]       # (cfg, params, tokens, **kw)
    decode_step: Optional[Callable]   # (cfg, params, cache, token, pos)
    init_cache: Optional[Callable]    # (cfg, batch, max_len, device)


def get_api(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as M
        return ModelAPI(M.init_params, M.train_loss, M.prefill,
                        M.decode_step, M.init_cache)
    if fam == "ssm":
        from repro_torch.models import ssm as M
        return ModelAPI(
            M.init_params, M.train_loss, M.prefill, M.decode_step,
            lambda cfg, b, _ml, device="cuda": M.init_state(cfg, b, device))
    if fam == "hybrid":
        from repro_torch.models import hybrid as M
        return ModelAPI(M.init_params, M.train_loss, M.prefill,
                        M.decode_step, M.init_cache)
    if fam == "encdec":
        from repro_torch.models import encdec as M
        return ModelAPI(M.init_params, M.train_loss, M.prefill,
                        M.decode_step, M.init_cache)
    if fam == "ardit":
        from repro_torch.models import ardit as M
        return ModelAPI(M.init_params, M.train_loss, None, None, None)
    raise ValueError(f"unknown family {fam!r}")


def init_fn(cfg: ModelConfig) -> Callable:
    """``(generator, device="cuda") -> params`` for ``cfg``."""
    api = get_api(cfg)
    return lambda generator, device="cuda": api.init(cfg, generator, device)


# ---------------------------------------------------------------------------
# dry-run stand-ins (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _embed_dtype(cfg: ModelConfig) -> torch.dtype:
    from repro_torch.models.layers import DTYPES
    return DTYPES[cfg.param_dtype]


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Batch stand-ins for the given shape cell.

    train:   the full train batch (tokens/targets or latents for AR-DiT).
    prefill: {tokens [B,S]} (+ frontend stubs).
    decode:  {token [B,1], pos [B]} — the cache comes from ``cache_specs``.
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    emb = _embed_dtype(cfg)
    if cfg.family == "ardit":
        from repro_torch.models import ardit as A
        tc = A.chunk_tokens(cfg)
        n_chunks = max(1, s // tc)
        return {
            "latents": _meta((b, n_chunks, tc, A.LATENT_CH), emb),
            "cond": _meta((b, A.COND_TOKENS, cfg.d_model), emb),
            "t": _meta((b, n_chunks), torch.float32),
            "noise": _meta((b, n_chunks, tc, A.LATENT_CH), emb),
        }
    frontend = {"vlm": "img_embeds", "encdec": "audio_embeds"}.get(
        cfg.family)
    s_text = s - cfg.n_frontend_tokens if cfg.family == "vlm" else s
    stub = {frontend: _meta((b, cfg.n_frontend_tokens, cfg.d_model), emb)} \
        if frontend else {}
    if shape.kind == "train":
        return {"tokens": _meta((b, s_text), i32),
                "targets": _meta((b, s_text), i32), **stub}
    if shape.kind == "prefill":
        return {"tokens": _meta((b, s_text), i32), **stub}
    # decode: one new token against a cache of seq_len
    return {"token": _meta((b, 1), i32), "pos": _meta((b,), i32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Any:
    """Meta-tensor tree of the decode cache for the shape cell."""
    api = get_api(cfg)
    assert api.init_cache is not None, cfg.name
    return api.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device="meta")


def param_specs(cfg: ModelConfig) -> Any:
    """Meta-tensor tree of the parameters (nothing drawn or allocated)."""
    return get_api(cfg).init(cfg, None, device="meta")
