"""The port's model registry against the JAX reference's, over every
config the port registers (the reference's twelve).

* The reference's ``test_registry_smoke_every_config`` on the port:
  every config builds params through ``registry.init_fn`` (on the CPU,
  from a torch generator) and survives one reduced step — a chunk of
  ``serve_chunk`` for the AR-DiT family (the live co-serve path), a
  prefill for the token families (the simulated co-serve families;
  ``encdec`` with its stub audio frames).
* ``input_specs`` / ``cache_specs`` / ``param_specs`` at full size:
  meta tensors with the shapes and dtypes of the reference's
  ``ShapeDtypeStruct``s (``jax.eval_shape``), for every config and
  shape cell, nothing allocated.
* ``configs.base.param_count`` on torch's meta device equals the
  reference's count for every config.
* ``convert.params_from_numpy`` carries the reference's bf16 MoE (fp32
  router inside) and hybrid trees bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import base as JB
from repro.models import registry as JR
from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.configs.base import param_count
from repro_torch.models import registry

torch.set_num_threads(2)

ARCHS = list(list_archs())


def test_the_port_registers_the_references_configs():
    assert ARCHS == list(JB.list_archs())
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(JB.get_config(arch))


def _batch(cfg, b, s, gen):
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    kw = {}
    stub = {"vlm": "img_embeds", "encdec": "audio_embeds"}.get(cfg.family)
    if stub:
        kw[stub] = 0.02 * torch.randn(
            (b, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
    return tokens, kw


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_smoke_every_config(arch):
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    params = registry.init_fn(cfg)(gen, device="cpu")
    leaves = list(_leaves(params))
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    if cfg.family == "ardit":
        from repro_torch.models import ardit as A
        cond = 0.02 * torch.randn((1, A.COND_TOKENS, cfg.d_model),
                                  generator=gen)
        cache = A.init_cache(cfg, params, cond)
        noise = torch.randn((1, A.chunk_tokens(cfg), A.LATENT_CH),
                            generator=gen)
        chunk, cache = A.serve_chunk(cfg, params, cache, noise)
        assert tuple(chunk.shape) == (1, A.chunk_tokens(cfg), A.LATENT_CH)
        assert bool(torch.isfinite(chunk).all()), arch
        assert cache["chunks"] == 1
        return
    api = registry.get_api(cfg)
    tokens, kw = _batch(cfg, 1, 16, gen)
    max_len = 20 + (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
    logits, cache, clen = api.prefill(cfg, params, tokens, max_len=max_len,
                                      **kw)
    assert tuple(logits.shape) == (1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()), arch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _same_specs(got, want):
    """Meta tensors with the reference's shapes and dtypes, key by key."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        t = got[k]
        assert t.is_meta, k
        assert tuple(t.shape) == tuple(w.shape), k
        assert str(t.dtype).split(".")[-1] == str(np.dtype(w.dtype)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), JB.get_config(arch)
    for shape in SHAPES.values():
        jshape = JB.SHAPES[shape.name]
        _same_specs(registry.input_specs(cfg, shape),
                    JR.input_specs(jcfg, jshape))
        if shape.kind != "decode":
            continue
        if cfg.family == "ardit":      # no token cache, as there
            with pytest.raises(AssertionError):
                registry.cache_specs(cfg, shape)
        else:
            _same_specs(registry.cache_specs(cfg, shape),
                        JR.cache_specs(jcfg, jshape))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_count_match_reference(arch):
    cfg, jcfg = get_config(arch), JB.get_config(arch)
    _same_specs(registry.param_specs(cfg), JR.param_specs(jcfg))
    assert param_count(cfg) == JB.param_count(jcfg)
    assert param_count(cfg.reduced()) == JB.param_count(jcfg.reduced())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_params_from_numpy_carries_bf16_family_trees(arch):
    """``convert.params_from_numpy`` takes the reference's bf16 trees as
    they are: the transformer's stacked layers with the MoE's fp32
    router inside, and the hybrid's ``periods/sub{j}`` stacks, each leaf
    with its shape, dtype and bits."""
    from repro_torch.models.convert import params_from_numpy
    jcfg = dataclasses.replace(JB.get_config(arch).reduced(),
                               param_dtype="bfloat16")
    jp = jax.tree_util.tree_map(np.asarray,
                                JR.init_fn(jcfg)(jax.random.PRNGKey(0)))
    got, want = _flat(params_from_numpy(jp)), _flat(jp)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        t = got[k]
        assert tuple(t.shape) == a.shape, k
        assert str(t.dtype).split(".")[-1] == str(a.dtype), k
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        assert np.array_equal(
            t.view(torch.int16 if bits is np.uint16 else torch.int32)
            .numpy().view(bits), a.view(bits)), k
    if jcfg.n_experts:
        routers = [k for k in got if k.endswith("/router")]
        assert routers and all(got[k].dtype == torch.float32
                               for k in routers)
