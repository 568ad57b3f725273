"""The port's AR-DiT serving surface (``repro_torch.models.ardit``)
against the JAX reference: ``denoise_step_paged`` (x_new and the chunk's
clean KV) with masks None, denoise-only and denoise + clean, plus the
sink KV, masks, schedules and init layout it relies on.

Params come from the reference's ``init_params`` with the adaLN gates
opened (``test_batcher.nondegenerate_params``: with zero gates the
output ignores the KV context and any parity would hold vacuously) and
cross through numpy (``convert.params_from_numpy``).  Reduced config,
2 layers, fp32: tolerance 1e-5 (rtol and atol).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ardit as JA
from repro.models import kvcache as JK
from repro_torch.models import ardit as TA
from repro_torch.models.convert import params_from_numpy

from test_batcher import nondegenerate_params, tiny_cfg
from test_torch_layers import _cfgs

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs(n_layers=2, ardit_window_chunks=2)
    assert jcfg == tiny_cfg(window_chunks=2)
    jp = nondegenerate_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_params_cross_with_stacked_layout(model):
    jcfg, tcfg, jp, tp = model
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tp) == shapes
    assert tp["layers"]["mod"].shape[0] == jcfg.n_layers
    np.testing.assert_array_equal(tp["layers"]["attn"]["wq"].numpy(),
                                  np.asarray(jp["layers"]["attn"]["wq"]))
    # the port's own init: same tree, shapes and dtypes
    own = TA.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), own) == shapes
    assert float(own["layers"]["mod"].abs().max()) == 0.0    # zero gates


def test_bf16_params_cross_as_bits():
    jcfg, _ = _cfgs(n_layers=2, param_dtype="bfloat16")
    jp = JA.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert tp["in_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["in_proj"].float().numpy(),
        np.asarray(jp["in_proj"].astype(jnp.float32)))


def test_masks_schedules_and_sparse_index(model):
    jcfg, tcfg, _, _ = model
    chunks = np.asarray([0, 1, 2, 5])
    windows = np.asarray([2, 1, 2, 1])
    rhos = np.asarray([0.0, 0.9, 0.6, 0.0])
    np.testing.assert_array_equal(
        TA.batched_context_mask_multi(tcfg, chunks, windows, rhos),
        JA.batched_context_mask_multi(jcfg, chunks, windows, rhos))
    np.testing.assert_array_equal(
        TA.batched_context_mask(tcfg, chunks, 2, 0.9),
        JA.batched_context_mask(jcfg, chunks, 2, 0.9))
    for ctx, rho in ((77 + 7 * 384, 0.8), (77 + 96, 0.9), (60, 0.7)):
        a, b = TA.cache_sparse_index(tcfg, ctx, rho), \
            JA.cache_sparse_index(jcfg, ctx, rho)
        assert (a is None and b is None) or np.array_equal(a, b)
    for s in (2, 3, 4):
        np.testing.assert_array_equal(TA.sigma_schedule(s),
                                      JA.sigma_schedule(s))
    assert TA.chunk_tokens(tcfg) == JA.chunk_tokens(jcfg)
    assert TA.cache_capacity(tcfg) == JA.cache_capacity(jcfg)
    assert TA.HIGHEST_QUALITY.key == JA.HIGHEST_QUALITY.key


def test_time_embed_and_sink_kv(model):
    jcfg, tcfg, jp, tp = model
    t = np.asarray([1.0, 0.5, 0.25, 0.0], np.float32)
    _close(TA._time_embed(tp, torch.from_numpy(t), tcfg.d_model),
           JA._time_embed(jp, jnp.asarray(t), jcfg.d_model))
    cond = (np.random.default_rng(5).normal(
        size=(2, TA.COND_TOKENS, tcfg.d_model)) * 0.02).astype(np.float32)
    want = JA.init_batched_cache(jcfg, jp, jnp.asarray(cond))
    got = TA.init_batched_cache(tcfg, tp, torch.from_numpy(cond))
    _close(got["k"], want["k"])
    _close(got["v"], want["v"])
    np.testing.assert_array_equal(got["chunks"], want["chunks"])


def _step_inputs(cfg, case):
    """A two-stream sub-batch over a random paged pool: one row mid
    denoise at fill 2, one row in its clean pass at fill 1."""
    rng = np.random.default_rng(17)
    tc = JA.chunk_tokens(cfg)
    page = max(JA.COND_TOKENS, tc)
    n_pages = 8
    shape = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    chunk_idx = np.asarray([2, 1])
    n_ring = 2
    tables = np.asarray([[5, 1, 6], [2, 7, 3]], np.int32)
    x = rng.normal(size=(2, tc, JA.LATENT_CH)).astype(np.float32)
    t = np.asarray([0.75, 0.0], np.float32)
    dt = np.asarray([0.25, 0.0], np.float32)
    is_dn = np.asarray([True, False])
    q_off = (JA.COND_TOKENS + chunk_idx * tc).astype(np.int32)
    ext = JA.COND_TOKENS + n_ring * tc

    def pages(rho, window):
        m = JA.batched_context_mask_multi(
            cfg, chunk_idx, np.asarray(window), np.asarray(rho))[:, :ext]
        return JK.mask_to_pages(m, n_ring, JA.COND_TOKENS, tc, page)

    dn = cl = None
    if case in ("dn", "dn+cl"):
        dn = pages([0.0, 0.0], [1, 2])
        dn[0, page:page + tc // 2] = False       # a sparsity-style drop
    if case == "dn+cl":
        cl = pages([0.0, 0.0], [2, 2])
    return (x, t, dt, kp, vp, tables, dn, cl, q_off, is_dn)


@pytest.mark.parametrize("case", ["none", "dn", "dn+cl"])
def test_denoise_step_paged_matches_jax(model, case):
    jcfg, tcfg, jp, tp = model
    args = _step_inputs(jcfg, case)
    jx, jkv = JA.denoise_step_paged(
        jcfg, jp, *(None if a is None else jnp.asarray(a) for a in args))
    tx, tkv = TA.denoise_step_paged(
        tcfg, tp, *(None if a is None else torch.from_numpy(a)
                    for a in args))
    _close(tx, jx)
    _close(tkv["k"], jkv["k"])
    _close(tkv["v"], jkv["v"])
    # the gates are open: the context really moves the output
    if case == "none":
        args2 = list(args)
        args2[3] = args2[3] * 0.5
        tx2, _ = TA.denoise_step_paged(
            tcfg, tp, *(None if a is None else torch.from_numpy(a)
                        for a in args2))
        assert float((tx2 - tx).abs().max()) > 1e-3
