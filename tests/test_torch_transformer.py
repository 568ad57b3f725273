"""The port's dense / MoE / VLM transformer (``repro_torch.models.
transformer``) against the JAX reference at the reduced configs (2-4
layers, d 64, 4 heads of 16, vocab 256, fp32): ``forward`` (hidden and
MoE aux), ``prefill`` (logits, K/V cache, cache_len) and three
``decode_step``s through ``registry.get_api``, for every dense / MoE /
VLM config of the registry (qwen1.5-32b has QKV biases, minicpm-2b tied
embeddings, granite-moe and qwen3-moe the MoE FFN, internvl2-26b image
embeddings prepended), and the windowed ring cache (sink 4 + window 8)
against the reference as decode rolls past the window.  Then the
reference's own ``test_prefill_decode_consistency`` and
``test_windowed_ring_cache_decode`` rerun on the port alone.

Parameters come from the reference's ``init_fn`` through
``convert.params_from_numpy``; inputs from numpy seeds.  Each framework
gets its own cache: the port's ``decode_step`` writes into its cache in
place.  Tolerance: 1e-5 (rtol and atol) in fp32 — the two frameworks
differ in summation order only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import registry as JR
from repro.models import transformer as JT
from repro_torch.configs.base import get_config
from repro_torch.models import layers as L
from repro_torch.models import registry, transformer
from repro_torch.models.convert import params_from_numpy

pytestmark = pytest.mark.slow     # JAX-compiling model tests

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.PRNGKey(0)
ARCHS = ["minitron-8b", "internlm2-20b", "qwen1.5-32b", "minicpm-2b",
         "granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "internvl2-26b"]
B, S = 2, 20

_MODELS = {}


def _model(arch, **replace):
    """(port cfg, JAX cfg, port params, JAX params) of the reduced
    config with ``replace``, the reference's fresh params carried across
    (window, sink and capacity leave the parameters alone, so the
    variants of one config share one init)."""
    if arch not in _MODELS:
        jp = JR.init_fn(jax_get_config(arch).reduced())(KEY)
        _MODELS[arch] = (params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp)), jp)
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **replace)
    return (cfg, jcfg) + _MODELS[arch]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _inputs(cfg, b, s, seed):
    """Tokens [b, s] and, for a VLM, image embeddings: numpy, then the
    port's and the reference's keyword arguments."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    tkw, jkw = {}, {}
    if cfg.family == "vlm":
        img = (0.02 * rng.normal(size=(b, cfg.n_frontend_tokens,
                                       cfg.d_model))).astype(np.float32)
        tkw["img_embeds"] = torch.from_numpy(img)
        jkw["img_embeds"] = jnp.asarray(img)
    return tokens, tkw, jkw


def _greedy(cfg, logits):
    return np.asarray(_np(logits)[:, :cfg.vocab_size].argmax(-1)[:, None],
                      np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, jcfg, tp, jp = _model(arch)
    tokens, tkw, jkw = _inputs(cfg, B, S, seed=1)
    h, aux = transformer.forward(cfg, tp, torch.from_numpy(tokens), **tkw)
    jh, jaux = JT.forward(jcfg, jp, jnp.asarray(tokens), **jkw)
    _close(h, jh)
    _close(aux, jaux)
    if cfg.n_experts:
        assert float(aux) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """prefill (logits, every cache entry, cache_len), then three greedy
    decode steps from each framework's own cache, the logits and the
    whole cache compared after every step."""
    cfg, jcfg, tp, jp = _model(arch)
    api, japi = registry.get_api(cfg), JR.get_api(jcfg)
    tokens, tkw, jkw = _inputs(cfg, B, S, seed=2)
    max_len = S + 4 + (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
    logits, cache, clen = api.prefill(cfg, tp, torch.from_numpy(tokens),
                                      max_len=max_len, **tkw)
    jlogits, jcache, jclen = japi.prefill(jcfg, jp, jnp.asarray(tokens),
                                          max_len=max_len, **jkw)
    assert tuple(logits.shape) == (B, cfg.padded_vocab)
    _close(logits, jlogits)
    assert clen.dtype == torch.int32
    np.testing.assert_array_equal(clen.numpy(), np.asarray(jclen))
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        _close(cache[name], jcache[name])
    pos, jpos = clen, jclen
    for _ in range(3):
        tok = _greedy(cfg, jlogits)
        logits, cache = api.decode_step(cfg, tp, cache, torch.from_numpy(tok),
                                        pos)
        jlogits, jcache = japi.decode_step(jcfg, jp, jcache,
                                           jnp.asarray(tok), jpos)
        pos, jpos = pos + 1, jpos + 1
        _close(logits, jlogits)
        for name in ("k", "v"):
            _close(cache[name], jcache[name])


def test_windowed_ring_cache_matches_reference():
    """minitron-8b reduced with a sink of 4 and a window of 8: the
    prefill of 20 tokens gathers the ring (capacity 12 < 20), and six
    decode steps write round it; logits and ring contents against the
    reference at every step."""
    cfg, jcfg, tp, jp = _model("minitron-8b", attn_window=8, attn_sink=4)
    tokens, _, _ = _inputs(cfg, 1, S, seed=3)
    logits, cache, pos = transformer.prefill(cfg, tp,
                                             torch.from_numpy(tokens),
                                             max_len=S + 8)
    jlogits, jcache, jpos = JT.prefill(jcfg, jp, jnp.asarray(tokens),
                                       max_len=S + 8)
    assert cache["k"].shape[2] == 12
    _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    for _ in range(6):
        tok = _greedy(cfg, jlogits)
        logits, cache = transformer.decode_step(cfg, tp, cache,
                                                torch.from_numpy(tok), pos)
        jlogits, jcache = JT.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                         jpos)
        pos, jpos = pos + 1, jpos + 1
        _close(logits, jlogits)
        _close(cache["v"], jcache["v"])


def test_attention_inputs_reach_the_kernel_contiguous():
    """``attn_qkv``'s q, k and v are contiguous (the flash kernel's
    wrapper refuses views), with and without QKV biases: no copy."""
    for arch in ("minitron-8b", "qwen1.5-32b"):
        cfg, _, tp, _ = _model(arch)
        x = torch.randn((2, 24, cfg.d_model),
                        generator=torch.Generator().manual_seed(0))
        q, k, v = L.attn_qkv(cfg, L.layer_params(tp, 0)["attn"], x,
                             torch.arange(24))
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()


# ---- the reference's serving-consistency tests, on the port alone --------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """The port's prefill + one decode step == its own forward over the
    extended sequence (the reference's test, its tolerance; MoE capacity
    lifted so the drops do not depend on the length)."""
    replace = {"capacity_factor": 8.0} if "moe" in arch else {}
    cfg, _, tp, _ = _model(arch, **replace)
    api = registry.get_api(cfg)
    tokens, tkw, _ = _inputs(cfg, B, S, seed=4)
    max_len = S + 4 + (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
    logits_p, cache, clen = api.prefill(cfg, tp, torch.from_numpy(tokens),
                                        max_len=max_len, **tkw)
    tok2 = torch.from_numpy(_greedy(cfg, logits_p))
    logits_d, cache = api.decode_step(cfg, tp, cache, tok2, clen)
    assert bool(torch.isfinite(logits_d).all())
    h, _ = transformer.forward(cfg, tp, torch.cat(
        [torch.from_numpy(tokens), tok2], 1), **tkw)
    ref = transformer._unembed(cfg, tp, h[:, -1:])[:, 0]
    np.testing.assert_allclose(logits_d.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_windowed_ring_cache_decode():
    """Dense windowed adaptation: ring-buffer decode == windowed full
    attention once positions roll past the window (the reference's
    test on the port)."""
    cfg, _, tp, _ = _model("minitron-8b", attn_window=8, attn_sink=4)
    tokens, _, _ = _inputs(cfg, 1, 12, seed=5)
    logits, cache, pos = transformer.prefill(cfg, tp,
                                             torch.from_numpy(tokens),
                                             max_len=24)
    assert cache["k"].shape[2] == 12          # sink+window capacity
    toks = [torch.from_numpy(tokens)]
    for _ in range(6):
        nxt = torch.from_numpy(_greedy(cfg, logits))
        toks.append(nxt)
        logits, cache = transformer.decode_step(cfg, tp, cache, nxt, pos)
        pos = pos + 1
    h, _ = transformer.forward(cfg, tp, torch.cat(toks, 1))
    ref = transformer._unembed(cfg, tp, h[:, -1:])[:, 0]
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=3e-3,
                               atol=3e-3)
