"""The port's layer substrate and attention (``repro_torch.models.layers``
/ ``attention``) against the JAX reference on the same numpy-seeded
inputs, at the reduced AR-DiT widths (d=64, 4 heads of 16).

Tolerance 1e-5 (rtol and atol): both sides compute in fp32 and differ
only in summation order and transcendental implementations.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.configs.base import get_config
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    j = dataclasses.replace(jax_get_config("ardit-self-forcing").reduced(),
                            **kw)
    t = dataclasses.replace(get_config("ardit-self-forcing").reduced(), **kw)
    return j, t


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _tree(rng, shapes, scale):
    return {k: _np(rng, *s, scale=scale) for k, s in shapes.items()}


def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = _np(rng, 2, 5, 4, 16)
    w = _np(rng, 16)
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    pos1 = np.arange(77, 82, dtype=np.int32)
    pos2 = np.stack([pos1, pos1 + 48]).astype(np.int32)
    for pos in (pos1, pos2):
        _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
               JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_attn_qkv_and_mlp(act):
    jcfg, tcfg = _cfgs(act=act)
    rng = np.random.default_rng(1)
    d, f, hd = jcfg.d_model, jcfg.d_ff, jcfg.n_heads * jcfg.head_dim
    attn = _tree(rng, {"wq": (d, hd), "wk": (d, hd), "wv": (d, hd),
                       "wo": (hd, d)}, 0.125)
    mlp = (_tree(rng, {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)},
                 0.1) if act == "swiglu" else
           _tree(rng, {"wi": (d, f), "wo": (f, d)}, 0.1))
    x = _np(rng, 2, 6, d)
    pos = np.stack([np.arange(6), np.arange(6) + 125]).astype(np.int32)
    tq = TL.attn_qkv(tcfg, {k: torch.from_numpy(v) for k, v in attn.items()},
                     torch.from_numpy(x), torch.from_numpy(pos))
    jq = JL.attn_qkv(jcfg, {k: jnp.asarray(v) for k, v in attn.items()},
                     jnp.asarray(x), jnp.asarray(pos))
    for a, b in zip(tq, jq):
        _close(a, b)
    _close(TL.mlp_block(tcfg, {k: torch.from_numpy(v) for k, v in mlp.items()},
                        torch.from_numpy(x)),
           JL.mlp_block(jcfg, {k: jnp.asarray(v) for k, v in mlp.items()},
                        jnp.asarray(x)))


def test_init_shapes_match_reference_layout():
    jcfg, tcfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    ja = JL.init_attn(jcfg, jax.random.PRNGKey(0), jnp.float32)
    ta = TL.init_attn(tcfg, g, torch.float32)
    assert {k: v.shape for k, v in ja.items()} == \
        {k: tuple(v.shape) for k, v in ta.items()}
    # dense_init scale 1/sqrt(fan_in)
    assert abs(float(ta["wq"].std()) - 1 / np.sqrt(tcfg.d_model)) < 0.02


@pytest.mark.parametrize("masked,causal", [(False, False), (True, False),
                                           (True, True)])
def test_mha_direct_path_with_kv_mask(masked, causal):
    rng = np.random.default_rng(2)
    B, Sq, Skv, Hq, Hkv, D = 3, 5, 11, 4, 2, 16
    q, k, v = _np(rng, B, Sq, Hq, D), _np(rng, B, Skv, Hkv, D), \
        _np(rng, B, Skv, Hkv, D)
    km = rng.random((B, Skv)) < 0.6
    km[2] = False                                # fully-masked row -> 0
    kw = dict(n_kv_heads=Hkv, causal=causal)
    if causal:                    # chunk at offset 6: sink 2 + window 4
        kw.update(q_offset=6, window=4, sink=2)
    got = TA.mha(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v),
                 kv_mask=torch.from_numpy(km) if masked else None, **kw)
    want = JA.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  kv_mask=jnp.asarray(km) if masked else None, **kw)
    _close(got, want)


def test_segment_merge_finalize():
    rng = np.random.default_rng(3)
    B, Sq, Hkv, G, D, S = 2, 4, 2, 2, 8, 9
    q = _np(rng, B, Sq, Hkv, G, D)
    k1, v1, k2, v2 = (_np(rng, B, S, Hkv, D) for _ in range(4))
    mask = rng.random((Sq, S)) < 0.5
    mask[0] = False                              # row fully masked here
    scale = 0.25
    t = [TA._segment_attn(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), m, scale)
         for k, v, m in ((k1, v1, torch.from_numpy(mask)), (k2, v2, None))]
    j = [JA._segment_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          m, scale)
         for k, v, m in ((k1, v1, jnp.asarray(mask)), (k2, v2, None))]
    for a, b in zip(t, j):
        for x, y in zip(a, b):
            _close(x, y)
    tm, jm = TA._merge(t[0], t[1]), JA._merge(j[0], j[1])
    for x, y in zip(tm, jm):
        _close(x, y)
    _close(TA._finalize(tm, torch.float32), JA._finalize(jm, jnp.float32))
    # _init_acc is the merge identity
    acc = TA._init_acc(B, Hkv, G, Sq, D)
    for x, y in zip(TA._merge(acc, t[1]), t[1]):
        _close(x, y)


def test_paged_mha_matches_jax():
    """paged partials (plain version) merged with the in-chunk segment,
    with a fully-masked page and a nearly-empty stream."""
    rng = np.random.default_rng(0)
    B, Sq, Hq, Hkv, D, n, page, ptot = 2, 6, 4, 2, 8, 3, 7, 9
    q = _np(rng, B, Sq, Hq, D)
    kp, vp = _np(rng, ptot, page, Hkv, D), _np(rng, ptot, page, Hkv, D)
    bt = rng.choice(ptot, size=(B, n), replace=False).astype(np.int32)
    mask = rng.random((B, n * page)) < 0.7
    mask[0, page:2 * page] = False
    mask[1, :] = False
    mask[1, :4] = True
    ck, cv = _np(rng, B, Sq, Hkv, D), _np(rng, B, Sq, Hkv, D)
    args = (q, kp, vp, bt, mask, ck, cv)
    got = TA.paged_mha(*(torch.from_numpy(a) for a in args), n_kv_heads=Hkv)
    want = JA.paged_mha(*(jnp.asarray(a) for a in args), n_kv_heads=Hkv)
    _close(got, want)


def test_shard_heads_and_sparse_keep_list():
    rng = np.random.default_rng(4)
    x = _np(rng, 2, 3, 8, 4)
    parts = [TA.shard_heads(torch.from_numpy(x), 4, lo, hi)
             for lo, hi in ((0, 1), (1, 4))]
    for p, (lo, hi) in zip(parts, ((0, 1), (1, 4))):
        _close(p, JA.shard_heads(jnp.asarray(x), 4, lo, hi))
    np.testing.assert_array_equal(TA.merge_head_shards(parts, [1, 3]), x)
    for n_kv, rho in ((9, 0.7), (5, 0.9), (1, 0.6), (12, 0.0)):
        assert TA.sparse_keep_list(1, [n_kv], rho) == \
            JA.sparse_keep_list(1, [n_kv], rho)
