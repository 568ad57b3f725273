"""The AR-DiT's ring batched cache in the port (``ardit.{chunk_step,
init_batched_cache, append_chunk_kv_batched, serve_chunk_batched}``,
``kvcache.write_block{,_layers}``), on the CPU at the reduced config (2
layers, fp32, the adaLN gates opened so that the KV context matters).

* The reference's specs in torch: ``write_block``'s per-row slots
  (``tests/test_batcher.py::test_write_block_per_row_dest``),
  ``serve_chunk_batched`` == ``serve_chunk`` per stream across fidelity
  switches, fp8 KV, sparsity and ring wrap-around, and a staggered join
  (``test_batched_matches_sequential_per_stream``,
  ``test_staggered_join_matches_sequential``, at their 1e-4 / 2e-4), and
  the paged pool == the stacked ring bit for bit
  (``tests/test_paged_pool.py::test_paged_pool_tracks_stacked_ring_
  bitwise``, ``test_serve_chunk_batched_paged_vs_ring_bitwise``,
  ``test_paged_join_leave_matches_ring_bitwise``).
* Against the JAX package: ``write_block_layers`` and
  ``serve_chunk_batched`` on the reference's params (rtol = atol =
  1e-5: the frameworks differ in summation order only), and an fp8
  chunk's KV bit for bit on the finite bytes (the e4m3 cast is
  ``kvcache.to_fp8_e4m3``, JAX's rule).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.fidelity import FidelityConfig
from repro_torch.models import ardit as A
from repro_torch.models import kvcache
from repro_torch.serve.batcher import KVPool

torch.set_num_threads(2)

FID_HI = FidelityConfig(2, 0.0, 2, "bf16")
FID_LO = FidelityConfig(2, 0.9, 1, "fp8")
SEQ_TOL = dict(rtol=1e-4, atol=2e-4)


def tiny_cfg(window_chunks=2):
    return dataclasses.replace(
        get_config("ardit-self-forcing").reduced(),
        n_layers=2, ardit_window_chunks=window_chunks)


def open_params(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return A.open_gates(A.init_params(cfg, g, "cpu"), g)


def randn(seed, *shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def conds(cfg, b, seed):
    return 0.02 * randn(seed, b, A.COND_TOKENS, cfg.d_model)


# ---------------------------------------------------------------------------
# write_block
# ---------------------------------------------------------------------------

def test_write_block_per_row_dest():
    cache = torch.zeros((2, 6, 1, 1))
    new = torch.arange(4, dtype=torch.float32).reshape(2, 2, 1, 1) + 1.0
    out = kvcache.write_block(cache, new, torch.tensor([0, 3]))
    assert out is cache                                   # in place
    got = cache[:, :, 0, 0].numpy()
    np.testing.assert_array_equal(got[0], [1, 2, 0, 0, 0, 0])
    np.testing.assert_array_equal(got[1], [0, 0, 0, 3, 4, 0])
    # a slot past cap - T writes the last T slots (dynamic_update_slice)
    kvcache.write_block(cache, -new, torch.tensor([5, 4]))
    np.testing.assert_array_equal(cache[:, 4:, 0, 0].numpy(),
                                  [[-1, -2], [-3, -4]])


def test_write_block_layers_matches_jax():
    """Against the reference's jitted ``write_block_layers``: an fp32
    cache, then an e4m3 cache written from fp32 blocks that overflow
    (NaN above 464 in both)."""
    from repro.models import kvcache as JK
    rng = np.random.default_rng(0)
    cache = rng.normal(size=(2, 3, 9, 2, 4)).astype(np.float32)
    new = (300 * rng.normal(size=(2, 3, 3, 2, 4))).astype(np.float32)
    dest = np.asarray([6, 0, 3], np.int32)
    want = np.asarray(JK.write_block_layers(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(dest)))
    got = torch.from_numpy(cache.copy())
    kvcache.write_block_layers(got, torch.from_numpy(new),
                               torch.from_numpy(dest))
    np.testing.assert_array_equal(got.numpy(), want)
    jf8 = np.asarray(JK.write_block_layers(
        jnp.asarray(cache).astype(jnp.float8_e4m3fn), jnp.asarray(new),
        jnp.asarray(dest))).astype(np.float32)
    tf8 = torch.from_numpy(cache).to(torch.float8_e4m3fn)
    kvcache.write_block_layers(tf8, torch.from_numpy(new),
                               torch.from_numpy(dest))
    tf8 = tf8.float().numpy()
    np.testing.assert_array_equal(np.isnan(tf8), np.isnan(jf8))
    assert np.isnan(jf8).any()
    fin = ~np.isnan(jf8)
    np.testing.assert_array_equal(tf8[fin], jf8[fin])


# ---------------------------------------------------------------------------
# serve_chunk_batched == serve_chunk per stream
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_batched_matches_sequential_per_stream():
    """Same params / cond / noise: ``serve_chunk_batched`` reproduces the
    sequential ``serve_chunk`` per stream across fidelity switches, fp8
    KV, sparsity and ring wrap-around."""
    cfg = tiny_cfg(window_chunks=2)
    p = open_params(cfg)
    B = 2
    cond = conds(cfg, B, 1)
    tc = A.chunk_tokens(cfg)
    fids = [FID_HI, FID_LO, FidelityConfig(3, 0.6, 2, "bf16"), FID_HI]
    seq = [A.init_cache(cfg, p, cond[i:i + 1]) for i in range(B)]
    bc = A.init_batched_cache(cfg, p, cond)
    for c, fid in enumerate(fids):             # wraps the 2-chunk ring
        # the same noise for every stream: a difference between the
        # streams' outputs can only come from their conds and caches
        noise = randn(100 * c, 1, tc, A.LATENT_CH)
        xb, bc = A.serve_chunk_batched(cfg, p, bc, noise.expand(B, -1, -1),
                                       fid)
        assert not torch.allclose(xb[0], xb[1]), \
            "outputs ignore the KV context"
        for i in range(B):
            xs, seq[i] = A.serve_chunk(cfg, p, seq[i], noise, fid)
            np.testing.assert_allclose(xb[i].numpy(), xs[0].numpy(),
                                       **SEQ_TOL)
    assert list(bc["chunks"]) == [len(fids)] * B


@pytest.mark.slow
def test_staggered_join_matches_sequential():
    """A stream joining at a chunk boundary (fills 2 and 0 in one
    sub-batch) stays on the sequential trajectory."""
    cfg = tiny_cfg(window_chunks=3)
    p = open_params(cfg)
    cond = conds(cfg, 2, 7)
    tc = A.chunk_tokens(cfg)

    def noise(seed):
        return randn(seed, 1, tc, A.LATENT_CH)

    s0 = A.init_cache(cfg, p, cond[0:1])
    s1 = A.init_cache(cfg, p, cond[1:2])
    bc = A.init_batched_cache(cfg, p, cond)
    for c in range(2):                         # stream 0 alone
        xs, s0 = A.serve_chunk(cfg, p, s0, noise(c), FID_HI)
        # a one-row view of the ring: the write lands in ``bc`` itself
        sub = {"k": bc["k"][:, :1], "v": bc["v"][:, :1],
               "chunks": bc["chunks"][:1]}
        xb, sub = A.serve_chunk_batched(cfg, p, sub, noise(c), FID_HI)
        bc["chunks"][:1] = sub["chunks"]
        np.testing.assert_allclose(xb[0].numpy(), xs[0].numpy(), **SEQ_TOL)
    x0, s0 = A.serve_chunk(cfg, p, s0, noise(10), FID_HI)
    x1, s1 = A.serve_chunk(cfg, p, s1, noise(11), FID_HI)
    xb, bc = A.serve_chunk_batched(
        cfg, p, bc, torch.cat([noise(10), noise(11)]), FID_HI)
    np.testing.assert_allclose(xb[0].numpy(), x0[0].numpy(), **SEQ_TOL)
    np.testing.assert_allclose(xb[1].numpy(), x1[0].numpy(), **SEQ_TOL)
    assert list(bc["chunks"]) == [3, 1]


# ---------------------------------------------------------------------------
# the paged pool == the stacked ring, bit for bit
# ---------------------------------------------------------------------------

def mk_pool(cfg, params, cond):
    pool = KVPool(cfg, params, cond.shape[0], device="cpu")
    for i in range(cond.shape[0]):
        assert pool.admit(i, cond[i:i + 1])
    return pool


def full_view(pool, sids):
    return pool.gather(sids, n_ring=pool.cfg.ardit_window_chunks)


@pytest.mark.parametrize("quant", ["bf16", "fp8"])
def test_paged_pool_tracks_stacked_ring_bitwise(quant):
    """Appending chunks through the page pool reproduces the stacked
    ring (``init_batched_cache`` + ``append_chunk_kv_batched``) bit for
    bit, through ring wrap-around, for both KV dtypes."""
    cfg = tiny_cfg(window_chunks=2)
    p = open_params(cfg)
    B, w = 2, cfg.ardit_window_chunks
    cond = conds(cfg, B, 3)
    tc = A.chunk_tokens(cfg)
    ring = A.init_batched_cache(cfg, p, cond)
    pool = mk_pool(cfg, p, cond)
    for c in range(w + 2):                     # wraps the ring twice
        kv = {n: randn(10 * c + i, cfg.n_layers, B, tc, cfg.n_kv_heads,
                       cfg.head_dim) for i, n in enumerate(("k", "v"))}
        if quant == "fp8":
            kv = {n: kvcache.to_fp8_e4m3(a) for n, a in kv.items()}
        ring = A.append_chunk_kv_batched(cfg, ring, kv)
        pool.append([0, 1], kv, quant="bf16")  # kv already cast above
        kf, vf = full_view(pool, [0, 1])
        assert tuple(kf.shape) == (cfg.n_layers, B, A.cache_capacity(cfg),
                                   cfg.n_kv_heads, cfg.head_dim)
        assert torch.equal(kf, ring["k"]) and torch.equal(vf, ring["v"])
        assert [pool.chunks[i] for i in range(B)] == list(ring["chunks"])
    pool.ledger.check()


def _paged_serve_chunk(cfg, p, pool, sids, noise, fid):
    """``serve_chunk_batched`` from a page-table-assembled cache, the
    produced chunk's KV paged back into the pool (the paged executor's
    data path through the ring entry point)."""
    w, tc = cfg.ardit_window_chunks, A.chunk_tokens(cfg)
    chunks = np.asarray([pool.chunks[s] for s in sids], np.int64)
    kf, vf = pool.gather(sids, n_ring=w)
    x, cache2 = A.serve_chunk_batched(cfg, p, {"k": kf, "v": vf,
                                               "chunks": chunks},
                                      noise, fid)
    slots = kvcache.chunk_slot(chunks, w, A.COND_TOKENS, tc)
    new = {n: torch.stack([cache2[n][:, i, s:s + tc]
                           for i, s in enumerate(slots)], dim=1)
           for n in ("k", "v")}
    pool.append(sids, new, quant="bf16")
    return x


@pytest.mark.slow
@pytest.mark.parametrize("window_chunks", [2, 3])
def test_serve_chunk_batched_paged_vs_ring_bitwise(window_chunks):
    """Page-table layout == stacked-ring layout, bit for bit, across
    fidelity windows, fp8 / bf16 KV, sparsity and ring wrap-around."""
    cfg = tiny_cfg(window_chunks=window_chunks)
    p = open_params(cfg)
    B = 2
    cond = conds(cfg, B, 1)
    tc = A.chunk_tokens(cfg)
    fids = [FidelityConfig(2, 0.0, 2, "bf16"),
            FidelityConfig(2, 0.9, 1, "fp8"),
            FidelityConfig(2, 0.6, window_chunks, "bf16"),
            FidelityConfig(2, 0.0, 2, "bf16")]  # wraps the ring
    ring = A.init_batched_cache(cfg, p, cond)
    pool = mk_pool(cfg, p, cond)
    for c, fid in enumerate(fids):
        noise = randn(100 * c, 1, tc, A.LATENT_CH).expand(B, -1, -1)
        x_ring, ring = A.serve_chunk_batched(cfg, p, ring, noise, fid)
        x_paged = _paged_serve_chunk(cfg, p, pool, [0, 1], noise, fid)
        assert torch.equal(x_paged, x_ring)
        kf, vf = full_view(pool, [0, 1])
        assert torch.equal(kf, ring["k"]) and torch.equal(vf, ring["v"])


@pytest.mark.slow
def test_paged_join_leave_matches_ring_bitwise():
    """Stream 0 runs two chunks alone, then stream 1 joins (fills 2 and
    0 in one sub-batch): the paged path stays bit for bit on the ring's
    trajectory."""
    cfg = tiny_cfg(window_chunks=3)
    p = open_params(cfg)
    cond = conds(cfg, 2, 7)
    tc = A.chunk_tokens(cfg)

    def noise(seed, b=1):
        return randn(seed, 1, tc, A.LATENT_CH).expand(b, -1, -1)

    ring = A.init_batched_cache(cfg, p, cond)
    pool = mk_pool(cfg, p, cond)
    for c in range(2):
        sub = {"k": ring["k"][:, :1], "v": ring["v"][:, :1],
               "chunks": ring["chunks"][:1]}
        x_r, sub = A.serve_chunk_batched(cfg, p, sub, noise(c), FID_HI)
        ring["chunks"][:1] = sub["chunks"]
        x_p = _paged_serve_chunk(cfg, p, pool, [0], noise(c), FID_HI)
        assert torch.equal(x_p, x_r)
    x_r, ring = A.serve_chunk_batched(cfg, p, ring, noise(10, 2), FID_HI)
    x_p = _paged_serve_chunk(cfg, p, pool, [0, 1], noise(10, 2), FID_HI)
    assert torch.equal(x_p, x_r)
    kf, vf = full_view(pool, [0, 1])
    assert torch.equal(kf, ring["k"]) and torch.equal(vf, ring["v"])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _jax_pair(window_chunks=2):
    from repro.models import ardit as JA
    from repro_torch.models.convert import params_from_numpy

    from test_batcher import nondegenerate_params
    from test_torch_layers import _cfgs
    jcfg, tcfg = _cfgs(n_layers=2, ardit_window_chunks=window_chunks)
    jp = nondegenerate_params(jcfg, jax.random.PRNGKey(0))
    return JA, jcfg, tcfg, jp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.slow
def test_serve_chunk_batched_matches_jax():
    """Three chunks for two streams at different fills (the second joins
    one chunk late), across a rho + fp8 fidelity: the latents and the
    whole ring against the reference's at 1e-5; the fp8 chunk's KV, as
    it lands in the ring, bit for bit on the finite bytes."""
    JA, jcfg, tcfg, jp, tp = _jax_pair()
    rng = np.random.default_rng(9)
    tc = A.chunk_tokens(tcfg)
    cond = (0.02 * rng.normal(size=(2, A.COND_TOKENS, tcfg.d_model))) \
        .astype(np.float32)
    jring = JA.init_batched_cache(jcfg, jp, jnp.asarray(cond))
    ring = A.init_batched_cache(tcfg, tp, torch.from_numpy(cond))
    np.testing.assert_allclose(ring["k"].numpy(), np.asarray(jring["k"]),
                               rtol=1e-5, atol=1e-5)
    jring["chunks"][1] = ring["chunks"][1] = 0
    for c, fid in enumerate([FID_HI, FidelityConfig(2, 0.6, 2, "fp8"),
                             FID_HI]):
        noise = rng.normal(size=(2, tc, A.LATENT_CH)).astype(np.float32)
        if c == 0:       # stream 1 joins one chunk late: a one-row view
            x, sub = A.serve_chunk_batched(
                tcfg, tp, {"k": ring["k"][:, :1], "v": ring["v"][:, :1],
                           "chunks": ring["chunks"][:1]},
                torch.from_numpy(noise[:1]), fid)
            ring["chunks"][:1] = sub["chunks"]
            jx, jsub = JA.serve_chunk_batched(
                jcfg, jp, {"k": jring["k"][:, :1], "v": jring["v"][:, :1],
                           "chunks": jring["chunks"][:1]},
                jnp.asarray(noise[:1]), fid)
            jring = {"k": jring["k"].at[:, :1].set(jsub["k"]),
                     "v": jring["v"].at[:, :1].set(jsub["v"]),
                     "chunks": np.concatenate([jsub["chunks"],
                                               jring["chunks"][1:]])}
        else:
            x, ring = A.serve_chunk_batched(tcfg, tp, ring,
                                            torch.from_numpy(noise), fid)
            jx, jring = JA.serve_chunk_batched(jcfg, jp, jring,
                                               jnp.asarray(noise), fid)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-5)
        assert list(ring["chunks"]) == list(jring["chunks"])
        for n in ("k", "v"):
            np.testing.assert_allclose(ring[n].numpy(),
                                       np.asarray(jring[n]), rtol=1e-5,
                                       atol=1e-5)
    assert list(ring["chunks"]) == [3, 2]


@pytest.mark.slow
def test_fp8_chunk_kv_matches_jax_bitwise():
    """The clean pass's KV of an fp8 chunk (``chunk_step``), cast to
    e4m3 by each framework's rule, scaled so that some entries overflow:
    NaN in the same places and the finite bytes equal (the fp32 inputs
    agree within 1e-5, far inside e4m3's rounding steps here)."""
    JA, jcfg, tcfg, jp, tp = _jax_pair()
    rng = np.random.default_rng(11)
    tc = A.chunk_tokens(tcfg)
    cond = (0.02 * rng.normal(size=(2, A.COND_TOKENS, tcfg.d_model))) \
        .astype(np.float32)
    ring = A.init_batched_cache(tcfg, tp, torch.from_numpy(cond))
    x = rng.normal(size=(2, tc, A.LATENT_CH)).astype(np.float32)
    chunks = np.asarray([0, 0])
    mask = A.batched_context_mask(tcfg, chunks, 2)
    q_off = np.full(2, A.COND_TOKENS, np.int32)
    t0 = np.zeros(2, np.float32)
    _, kv = A.chunk_step(tcfg, tp, torch.from_numpy(x), torch.from_numpy(t0),
                         ring["k"], ring["v"], torch.from_numpy(q_off),
                         torch.from_numpy(mask))
    jring = JA.init_batched_cache(jcfg, jp, jnp.asarray(cond))
    _, jkv = JA.chunk_step(jcfg, jp, jnp.asarray(x), jnp.asarray(t0),
                           jring["k"], jring["v"], jnp.asarray(q_off),
                           jnp.asarray(mask))
    for n in ("k", "v"):
        np.testing.assert_allclose(kv[n].numpy(), np.asarray(jkv[n]),
                                   rtol=1e-5, atol=1e-5)
        scale = 600.0 / float(kv[n].abs().max())
        got = kvcache.to_fp8_e4m3(kv[n] * scale).view(torch.uint8).numpy()
        want = np.asarray((jkv[n] * scale).astype(jnp.float8_e4m3fn)) \
            .view(np.uint8)
        nan_t = (got & 0x7F) == 0x7F
        nan_j = (want & 0x7F) == 0x7F
        np.testing.assert_array_equal(nan_t, nan_j)
        assert nan_j.any() and (~nan_j).any()
        np.testing.assert_array_equal(got[~nan_j], want[~nan_j])
