"""The port's encoder-decoder (``repro_torch.models.encdec``,
whisper-medium) against the JAX reference at the reduced config (2 + 2
layers, d 64, 4 heads of 16, vocab 256, 8 stub audio frames, fp32):
``encode``, ``_cross_kv`` / ``_cross_attn``, ``forward``, ``prefill``
(logits, the self ``k`` / ``v`` and cross ``ck`` / ``cv`` cache,
cache_len) and three ``decode_step``s through ``registry.get_api``, the
cache compared after every step.  Then the reference's own
``test_prefill_decode_consistency`` reruns on the port alone, at its
2e-3, and the registry's meta-device stand-ins are checked at full
width.

Parameters come from the reference's ``init_fn`` through
``convert.params_from_numpy``; inputs from numpy seeds.  Each framework
gets its own cache: the port's ``decode_step`` writes into its cache in
place.  Tolerance: 1e-5 (rtol and atol) in fp32 — the two frameworks
differ in summation order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import encdec as JE
from repro.models import registry as JR
from repro_torch.configs.base import PREFILL_32K, DECODE_32K, get_config
from repro_torch.configs.base import param_count
from repro_torch.models import encdec, registry
from repro_torch.models.convert import params_from_numpy

pytestmark = pytest.mark.slow     # JAX-compiling model tests

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "whisper-medium"
B, S = 2, 20

_MODEL = {}


def _model():
    """(port cfg, JAX cfg, port params, JAX params) of the reduced
    config, the reference's fresh params carried across."""
    if not _MODEL:
        jcfg = jax_get_config(ARCH).reduced()
        jp = JR.init_fn(jcfg)(jax.random.PRNGKey(0))
        _MODEL["m"] = (get_config(ARCH).reduced(), jcfg, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp)), jp)
    return _MODEL["m"]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _inputs(cfg, b, s, seed):
    """Tokens [b, s] and stub audio frames [b, n_frontend_tokens, d]:
    numpy, then the port's and the reference's forms."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    audio = (0.02 * rng.normal(size=(b, cfg.n_frontend_tokens,
                                     cfg.d_model))).astype(np.float32)
    return tokens, torch.from_numpy(audio), jnp.asarray(audio)


def _greedy(cfg, logits):
    return np.asarray(_np(logits)[:, :cfg.vocab_size].argmax(-1)[:, None],
                      np.int32)


def test_reduced_config_is_an_encoder_decoder():
    cfg, _, tp, _ = _model()
    assert cfg.family == "encdec" and cfg.n_frontend_tokens == 8
    assert cfg.act == "gelu" and cfg.param_dtype == "float32"
    assert tp["enc_layers"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
    assert set(tp["dec_layers"]) == {"attn_norm", "cross_norm", "mlp_norm",
                                     "attn", "cross", "mlp"}


def test_encode_matches_reference():
    cfg, jcfg, tp, jp = _model()
    _, audio, jaudio = _inputs(cfg, B, S, seed=1)
    _close(encdec.encode(cfg, tp, audio), JE.encode(jcfg, jp, jaudio))


def test_cross_attention_matches_reference():
    """``_cross_kv`` and ``_cross_attn`` of one decoder layer over the
    encoder states, at the prefill's S rows and at decode's one row."""
    cfg, jcfg, tp, jp = _model()
    _, audio, jaudio = _inputs(cfg, B, S, seed=2)
    enc = encdec.encode(cfg, tp, audio)
    jenc = JE.encode(jcfg, jp, jaudio)
    lp = encdec._layer(tp["dec_layers"], 1)["cross"]
    jlp = jax.tree_util.tree_map(lambda a: a[1], jp["dec_layers"])["cross"]
    k, v = encdec._cross_kv(cfg, lp, enc)
    jk, jv = JE._cross_kv(jcfg, jlp, jenc)
    _close(k, jk)
    _close(v, jv)
    rng = np.random.default_rng(3)
    for rows in (S, 1):
        x = rng.normal(size=(B, rows, cfg.d_model)).astype(np.float32)
        _close(encdec._cross_attn(cfg, lp, torch.from_numpy(x), k, v),
               JE._cross_attn(jcfg, jlp, jnp.asarray(x), jk, jv))


def test_forward_matches_reference():
    cfg, jcfg, tp, jp = _model()
    tokens, audio, jaudio = _inputs(cfg, B, S, seed=4)
    h = encdec.forward(cfg, tp, torch.from_numpy(tokens), audio)
    _close(h, JE.forward(jcfg, jp, jnp.asarray(tokens), jaudio))
    _close(encdec._unembed(cfg, tp, h[:, -1:]),
           JE._unembed(jcfg, jp, JE.forward(jcfg, jp, jnp.asarray(tokens),
                                            jaudio)[:, -1:]))


def test_prefill_and_decode_match_reference():
    """prefill (logits, every cache entry, cache_len), then three greedy
    decode steps from each framework's own cache, the logits and the
    whole cache compared after every step."""
    cfg, jcfg, tp, jp = _model()
    api, japi = registry.get_api(cfg), JR.get_api(jcfg)
    tokens, audio, jaudio = _inputs(cfg, B, S, seed=5)
    logits, cache, clen = api.prefill(cfg, tp, torch.from_numpy(tokens),
                                      audio_embeds=audio, max_len=S + 4)
    jlogits, jcache, jclen = japi.prefill(jcfg, jp, jnp.asarray(tokens),
                                          audio_embeds=jaudio, max_len=S + 4)
    assert tuple(logits.shape) == (B, cfg.padded_vocab)
    _close(logits, jlogits)
    assert clen.dtype == torch.int32
    np.testing.assert_array_equal(clen.numpy(), np.asarray(jclen))
    assert sorted(cache) == sorted(jcache) == ["ck", "cv", "k", "v"]
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape
        _close(cache[name], jcache[name])
    pos, jpos = clen, jclen
    for _ in range(3):
        tok = _greedy(cfg, jlogits)
        logits, cache2 = api.decode_step(cfg, tp, cache,
                                         torch.from_numpy(tok), pos)
        assert all(cache2[n] is cache[n] for n in cache)   # in place
        jlogits, jcache = japi.decode_step(jcfg, jp, jcache,
                                           jnp.asarray(tok), jpos)
        pos, jpos = pos + 1, jpos + 1
        _close(logits, jlogits)
        for name in cache:
            _close(cache[name], jcache[name])


def test_init_cache_matches_reference():
    cfg, jcfg, _, _ = _model()
    got = registry.get_api(cfg).init_cache(cfg, 3, 40, device="cpu")
    want = JE.init_cache(jcfg, 3, 40)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape
        assert got[name].dtype == torch.float32
        assert not bool(got[name].any())


def test_training_loss_is_a_finite_scalar():
    """The registry's ``loss`` is ``encdec.train_loss``: a finite fp32
    scalar at the reduced config (its gradients against JAX's are in
    tests/test_torch_train.py)."""
    cfg, _, params, _ = _model()
    api = registry.get_api(cfg)
    assert api.loss is encdec.train_loss
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    audio = torch.from_numpy((0.02 * rng.standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32))
    loss = api.loss(cfg, params, {"tokens": tokens, "targets": tokens,
                                  "audio_embeds": audio})
    assert loss.shape == () and loss.dtype == torch.float32
    assert bool(torch.isfinite(loss))


# ---- the reference's serving-consistency test, on the port alone ---------

def test_prefill_decode_consistency():
    """The port's prefill + one decode step == its own forward over the
    extended sequence (the reference's test at whisper-medium, its
    tolerance)."""
    cfg, _, tp, _ = _model()
    api = registry.get_api(cfg)
    tokens, audio, _ = _inputs(cfg, B, S, seed=6)
    logits_p, cache, clen = api.prefill(cfg, tp, torch.from_numpy(tokens),
                                        audio_embeds=audio, max_len=S + 4)
    tok2 = torch.from_numpy(_greedy(cfg, logits_p))
    logits_d, cache = api.decode_step(cfg, tp, cache, tok2, clen)
    assert bool(torch.isfinite(logits_d).all())
    h = encdec.forward(cfg, tp, torch.cat([torch.from_numpy(tokens), tok2],
                                          1), audio)
    ref = encdec._unembed(cfg, tp, h[:, -1:])[:, 0]
    np.testing.assert_allclose(logits_d.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3)


# ---- the registry's stand-ins at full width (meta device) ----------------

def test_specs_at_full_width_on_meta():
    """``param_specs`` and ``cache_specs`` for whisper-medium itself:
    meta tensors of the full shapes (24 + 24 layers, d 1024, 16 heads of
    64, vocab 51,865 padded to 51,968), nothing allocated; the count is
    the reference's."""
    from repro.configs import base as JB
    cfg = get_config(ARCH)
    p = registry.param_specs(cfg)
    assert p["embed"].is_meta and tuple(p["embed"].shape) == (51968, 1024)
    assert tuple(p["enc_layers"]["mlp"]["wi"].shape) == (24, 1024, 4096)
    assert tuple(p["dec_layers"]["cross"]["wq"].shape) == (24, 1024, 1024)
    assert param_count(cfg) == JB.param_count(JB.get_config(ARCH))
    c = registry.cache_specs(cfg, DECODE_32K)
    assert tuple(c["k"].shape) == (24, 128, 32768, 16, 64)
    assert tuple(c["ck"].shape) == (24, 128, 1500, 16, 64)
    assert all(t.is_meta and t.dtype == torch.bfloat16 for t in c.values())
    spec = registry.input_specs(cfg, PREFILL_32K)
    assert tuple(spec["audio_embeds"].shape) == (32, 1500, 1024)
