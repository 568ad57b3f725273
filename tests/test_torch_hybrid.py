"""The port's Jamba-style hybrid model (``repro_torch.models.hybrid``)
against the JAX reference at the reduced jamba-v0.1-52b config (one
period of 4 sublayers: 3 Mamba + 1 attention, MoE on every other; d 64,
4 heads of 16, 8 SSD heads of 16, state 16, chunk 16, 4 experts top 2,
fp32): the sublayer plan, the parameter tree, ``forward``, ``prefill``
(logits, every conv / SSM state and KV ring, cache_len) and three
``decode_step``s through ``registry.get_api``; then a sink of 4 and a
window of 8, so the prefill gathers the ring and six decode steps roll
past the window, against the reference at every step; and the
reference's ``test_prefill_decode_consistency`` on the port alone.

Parameters come from the reference's ``init_fn`` through
``convert.params_from_numpy``; inputs from numpy seeds.  Each framework
gets its own cache (the port's ``decode_step`` writes into it in place).
Tolerance: 1e-5 (rtol and atol) in fp32, summation order only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import hybrid as JH
from repro.models import registry as JR
from repro_torch.configs.base import get_config
from repro_torch.models import hybrid, registry
from repro_torch.models.convert import params_from_numpy

pytestmark = pytest.mark.slow     # JAX-compiling model tests

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.PRNGKey(0)
ARCH = "jamba-v0.1-52b"
B, S = 2, 20

_MODELS = {}


def _model(**replace):
    """(port cfg, JAX cfg, port params, JAX params): the reduced config
    with ``replace`` (window, sink and capacity leave the parameters
    alone, so every variant shares the reference's one init)."""
    if not _MODELS:
        jp = JR.init_fn(jax_get_config(ARCH).reduced())(KEY)
        _MODELS["params"] = (params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp)), jp)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **replace)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **replace)
    return (cfg, jcfg) + _MODELS["params"]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _close_trees(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        _close(got[k], w)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _greedy(cfg, logits):
    return np.asarray(_np(logits)[:, :cfg.vocab_size].argmax(-1)[:, None],
                      np.int32)


def test_sublayer_plan_and_params_match_reference():
    for arch_cfg in (get_config(ARCH), get_config(ARCH).reduced()):
        jcfg = jax_get_config(ARCH) if "reduced" not in arch_cfg.name \
            else jax_get_config(ARCH).reduced()
        assert hybrid.period_len(arch_cfg) == JH.period_len(jcfg)
        assert hybrid.sublayer_kinds(arch_cfg) == JH.sublayer_kinds(jcfg)
    assert hybrid.sublayer_kinds(get_config(ARCH)) == [
        ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
        ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe"),
        ("mamba", "mlp"), ("mamba", "moe")]
    cfg, jcfg, _, _ = _model()
    got = _flat(hybrid.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu"))
    want = _flat(jax.eval_shape(lambda: JH.init_params(jcfg, KEY)))
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k


def test_forward_matches_reference():
    cfg, jcfg, tp, jp = _model()
    tokens = _tokens(B, S, seed=1)
    h, aux = hybrid.forward(cfg, tp, torch.from_numpy(tokens))
    jh, jaux = JH.forward(jcfg, jp, jnp.asarray(tokens))
    _close(h, jh)
    _close(aux, jaux)


@pytest.mark.parametrize("window", [0, 8], ids=["full", "ring"])
def test_prefill_and_decode_match_reference(window):
    """prefill, then greedy decode steps, each framework from its own
    cache, logits and every cache entry compared after every step.  With
    a window of 8 and a sink of 4 the capacity is 12: the prefill of 20
    tokens gathers the ring and six steps write round it."""
    replace = dict(attn_window=window, attn_sink=4) if window else {}
    cfg, jcfg, tp, jp = _model(**replace)
    api, japi = registry.get_api(cfg), JR.get_api(jcfg)
    tokens = _tokens(B, S, seed=2)
    max_len = S + 8
    logits, cache, clen = api.prefill(cfg, tp, torch.from_numpy(tokens),
                                      max_len=max_len)
    jlogits, jcache, jclen = japi.prefill(jcfg, jp, jnp.asarray(tokens),
                                          max_len=max_len)
    _close(logits, jlogits)
    np.testing.assert_array_equal(clen.numpy(), np.asarray(jclen))
    _close_trees(cache, jcache)
    if window:
        assert cache["sub2"]["k"].shape[2] == 12
    pos, jpos = clen, jclen
    for _ in range(6 if window else 3):
        tok = _greedy(cfg, jlogits)
        logits, cache = api.decode_step(cfg, tp, cache, torch.from_numpy(tok),
                                        pos)
        jlogits, jcache = japi.decode_step(jcfg, jp, jcache,
                                           jnp.asarray(tok), jpos)
        pos, jpos = pos + 1, jpos + 1
        _close(logits, jlogits)
        _close_trees(cache, jcache)


def test_prefill_decode_consistency():
    """The reference's test on the port alone: prefill + one decode step
    == the port's forward over the extended sequence (MoE capacity
    lifted so the drops do not depend on the length)."""
    cfg, _, tp, _ = _model(capacity_factor=8.0)
    api = registry.get_api(cfg)
    tokens = torch.from_numpy(_tokens(B, S, seed=4))
    logits_p, cache, clen = api.prefill(cfg, tp, tokens, max_len=S + 4)
    tok2 = torch.from_numpy(_greedy(cfg, logits_p))
    logits_d, cache = api.decode_step(cfg, tp, cache, tok2, clen)
    assert bool(torch.isfinite(logits_d).all())
    h, _ = hybrid.forward(cfg, tp, torch.cat([tokens, tok2], 1))
    ref = hybrid._unembed(cfg, tp, h[:, -1:])[:, 0]
    np.testing.assert_allclose(logits_d.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3)
