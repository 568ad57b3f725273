"""The port's sequential serving path and gather context backend against
the JAX reference: ``kvcache.gather_pages`` (an exact permutation),
``ardit.chunk_forward`` (no context, the rho token gather, per-stream
offsets with a context mask), ``denoise_step`` (masks none / denoise /
denoise + clean), ``serve_chunk`` over a warm cache (top fidelity, rho
0.5, W 3, fp8, and fp8 KV past 464 turning NaN as in JAX), and
``ChunkExecutor.generate_chunk`` with the reference's draws injected.
Port-only: a sequential session's chunks equal its executor's bit for
bit, the paged and gather backends agree, and the launcher runs both on
the CPU.

Params come from the reference's ``init_params`` with the adaLN gates
opened and cross through numpy; inputs come from numpy seeds.  Reduced
config, 2 layers, fp32: tolerance 1e-5 (rtol and atol).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ardit as JA
from repro.models import kvcache as JK
from repro.serve.executor import ChunkExecutor as JChunkExecutor
from repro_torch.core.bmpr import StaticFidelity
from repro_torch.core.fidelity import FidelityConfig, HIGHEST_QUALITY
from repro_torch.models import ardit as TA
from repro_torch.models import kvcache as TK
from repro_torch.models.convert import params_from_numpy
from repro_torch.sched_sim import cost_model as cm
from repro_torch.sched_sim.workloads import StreamSpec
from repro_torch.serve import batcher as TB
from repro_torch.serve import executor as TE
from repro_torch.serve import session as TS

from test_batcher import nondegenerate_params
from test_torch_batcher import jax_cond, jax_noise
from test_torch_layers import _cfgs

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _params(**kw):
    jcfg, tcfg = _cfgs(n_layers=2, **kw)
    jp = nondegenerate_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def model():
    """8-chunk window: at the reduced chunk of 48 tokens a full window
    is the first context long enough (3 blocks of 128) for rho to drop
    cached tokens."""
    return _params(ardit_window_chunks=8)


@pytest.mark.parametrize("n_ring", [0, 1, 2])
def test_gather_pages_matches_manual_assembly(n_ring):
    L, n_pages, P, H, D = 2, 8, 7, 1, 3
    sink, tc = 5, 7
    pool = np.random.default_rng(0).normal(
        size=(L, n_pages, P, H, D)).astype(np.float32)
    tables = np.array([[0, 3, 5], [2, 6, 1]], np.int32)
    got = TK.gather_pages(torch.from_numpy(pool), torch.from_numpy(tables),
                          sink, tc, n_ring).numpy()
    for b, tab in enumerate(tables):
        parts = [pool[:, tab[0], :sink]]
        parts += [pool[:, tab[1 + r], :tc] for r in range(n_ring)]
        np.testing.assert_array_equal(got[:, b],
                                      np.concatenate(parts, axis=1))
    np.testing.assert_array_equal(got, np.asarray(JK.gather_pages(
        jnp.asarray(pool), jnp.asarray(tables), sink, tc, n_ring)))


def _forward_inputs(cfg, case):
    rng = np.random.default_rng(23)
    tc = JA.chunk_tokens(cfg)
    b = 1 if case == "rho" else 2
    ctx = {"none": 0, "rho": JA.COND_TOKENS + 10 * tc,
           "mask": JA.COND_TOKENS + 2 * tc}[case]
    x = rng.normal(size=(b, tc, JA.LATENT_CH)).astype(np.float32)
    t = rng.random(b).astype(np.float32)
    shape = (cfg.n_layers, b, ctx, cfg.n_kv_heads, cfg.head_dim)
    ck = rng.normal(size=shape).astype(np.float32) if ctx else None
    cv = rng.normal(size=shape).astype(np.float32) if ctx else None
    kw = dict(q_offset=JA.COND_TOKENS + 2 * tc)
    mask = None
    if case == "rho":
        kw["sparsity"] = 0.5
    if case == "mask":
        kw["q_offset"] = (JA.COND_TOKENS
                          + np.asarray([2, 1]) * tc).astype(np.int32)
        mask = rng.random((b, ctx)) < 0.7
    return x, t, ck, cv, mask, kw


@pytest.mark.parametrize("case", ["none", "rho", "mask"])
def test_chunk_forward_matches_jax(model, case):
    jcfg, tcfg, jp, tp = model
    x, t, ck, cv, mask, kw = _forward_inputs(jcfg, case)
    if case == "rho":        # the gather really drops cached tokens
        keep = JA.cache_sparse_index(jcfg, ck.shape[2], 0.5)
        assert keep is not None and len(keep) < ck.shape[2]

    def to(conv, a):
        return None if a is None else conv(a)

    jo, jkv = JA.chunk_forward(
        jcfg, jp, jnp.asarray(x), jnp.asarray(t), to(jnp.asarray, ck),
        to(jnp.asarray, cv), ctx_mask=to(jnp.asarray, mask),
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    to_t = torch.from_numpy
    to_kw = {k: (to_t(v) if isinstance(v, np.ndarray) else v)
             for k, v in kw.items()}
    to_o, tkv = TA.chunk_forward(
        tcfg, tp, to_t(x), to_t(t), to(to_t, ck), to(to_t, cv),
        ctx_mask=to(to_t, mask), **to_kw)
    _close(to_o, jo)
    _close(tkv["k"], jkv["k"])
    _close(tkv["v"], jkv["v"])


@pytest.mark.parametrize("case", ["none", "dn", "dn+cl"])
def test_denoise_step_matches_jax(model, case):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(31)
    tc = JA.chunk_tokens(jcfg)
    ctx = JA.COND_TOKENS + 2 * tc
    shape = (jcfg.n_layers, 2, ctx, jcfg.n_kv_heads, jcfg.head_dim)
    args = [rng.normal(size=(2, tc, JA.LATENT_CH)).astype(np.float32),
            np.asarray([0.75, 0.0], np.float32),
            np.asarray([0.25, 0.0], np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            (JA.COND_TOKENS + np.asarray([2, 1]) * tc).astype(np.int32),
            None, None, np.asarray([True, False])]
    if case in ("dn", "dn+cl"):
        args[6] = rng.random((2, ctx)) < 0.6
    if case == "dn+cl":
        args[7] = rng.random((2, ctx)) < 0.8
    jx, jkv = JA.denoise_step(jcfg, jp, *(None if a is None
                                          else jnp.asarray(a) for a in args))
    tx, tkv = TA.denoise_step(tcfg, tp, *(None if a is None
                                          else torch.from_numpy(a)
                                          for a in args))
    _close(tx, jx)
    _close(tkv["k"], jkv["k"])
    _close(tkv["v"], jkv["v"])


WARM_FID = (2, 0.0, 8, "bf16")


@pytest.fixture(scope="module")
def warm(model):
    """Both frameworks' caches after 8 chunks (a full window) of one
    stream from the same cond and noise."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(41)
    cond = (rng.normal(size=(1, JA.COND_TOKENS, jcfg.d_model))
            * 0.02).astype(np.float32)
    jc = JA.init_cache(jcfg, jp, jnp.asarray(cond))
    tcache = TA.init_cache(tcfg, tp, torch.from_numpy(cond))
    _close(tcache["k"], jc["k"])
    tc = JA.chunk_tokens(jcfg)
    for _ in range(8):
        noise = rng.normal(size=(1, tc, JA.LATENT_CH)).astype(np.float32)
        jx, jc = JA.serve_chunk(jcfg, jp, jc, jnp.asarray(noise),
                                JA.FidelityConfig(*WARM_FID))
        tx, tcache = TA.serve_chunk(tcfg, tp, tcache,
                                    torch.from_numpy(noise),
                                    FidelityConfig(*WARM_FID))
        _close(tx, jx)
    assert tcache["len"] == jc["len"] == TA.cache_capacity(tcfg)
    return jc, tcache, rng.normal(size=(1, tc, JA.LATENT_CH)).astype(
        np.float32)


@pytest.mark.parametrize("fid", [tuple(HIGHEST_QUALITY), (2, 0.5, 8, "bf16"),
                                 (3, 0.0, 3, "bf16"), (2, 0.0, 8, "fp8")],
                         ids=["top", "rho0.5", "W3", "fp8"])
def test_serve_chunk_matches_jax(model, warm, fid):
    jcfg, tcfg, jp, tp = model
    jc, tcache, noise = warm
    jx, jc2 = JA.serve_chunk(jcfg, jp, jc, jnp.asarray(noise),
                             JA.FidelityConfig(*fid))
    tx, tc2 = TA.serve_chunk(tcfg, tp, tcache, torch.from_numpy(noise),
                             FidelityConfig(*fid))
    _close(tx, jx)
    # the full ring evicts its oldest chunk on append
    assert (tc2["len"], tc2["chunks"]) == (jc2["len"], jc2["chunks"]) \
        == (TA.cache_capacity(tcfg), 9)
    _close(tc2["k"], jc2["k"])
    _close(tc2["v"], jc2["v"])


def test_serve_chunk_fp8_overflow_matches_jax():
    """Clean KV past 464 becomes NaN in the fp8 cache, as in JAX (torch's
    own cast would saturate to 448)."""
    jcfg, tcfg, jp, _ = _params(ardit_window_chunks=2)
    jp["layers"]["attn"]["wk"] = jp["layers"]["attn"]["wk"].at[0].multiply(
        2000.0)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(43)
    cond = (rng.normal(size=(1, JA.COND_TOKENS, jcfg.d_model))
            * 0.02).astype(np.float32)
    noise = rng.normal(size=(1, JA.chunk_tokens(jcfg), JA.LATENT_CH)) \
        .astype(np.float32)
    fid = (2, 0.0, 2, "fp8")
    jx, jc = JA.serve_chunk(jcfg, jp, JA.init_cache(jcfg, jp,
                                                    jnp.asarray(cond)),
                            jnp.asarray(noise), JA.FidelityConfig(*fid))
    tx, tcache = TA.serve_chunk(tcfg, tp, TA.init_cache(
        tcfg, tp, torch.from_numpy(cond)), torch.from_numpy(noise),
        FidelityConfig(*fid))
    _close(tx, jx)
    jk, tk = np.asarray(jc["k"]), tcache["k"].numpy()
    assert np.isnan(jk).sum() > 0
    np.testing.assert_array_equal(np.isnan(tk), np.isnan(jk))
    # finite keys agree to one e4m3 step (3 mantissa bits): fp32 inputs
    # 1e-6 apart can round to neighbouring fp8 values at a boundary
    np.testing.assert_allclose(tk, jk, rtol=2.0 ** -3, atol=0)
    _close(tcache["v"], jc["v"])


@pytest.fixture
def inject_jax_draws(monkeypatch):
    monkeypatch.setattr(TE, "cond_noise", jax_cond)
    monkeypatch.setattr(TE, "chunk_noise", jax_noise)


def test_generate_chunk_matches_jax(inject_jax_draws):
    jcfg, tcfg, jp, tp = _params(ardit_window_chunks=2)
    jex = JChunkExecutor(cfg=jcfg, params=jp)
    tex = TE.ChunkExecutor(cfg=tcfg, params=tp, device="cpu")
    js = jex.open_stream(3, 3, now=0.0, ttfc_slack=1.0, seed=3)
    ts = tex.open_stream(3, 3, now=0.0, ttfc_slack=1.0, seed=3)
    _close(ts.cond, js.cond)
    # fp8 last: KV rounded to neighbouring fp8 values at a boundary
    # would move every later chunk by more than the fp32 tolerance
    for fid in ((2, 0.0, 2, "bf16"), (3, 0.0, 1, "bf16"),
                (2, 0.0, 2, "fp8")):
        _close(ts.cache["k"], js.cache["k"])
        jx, _ = jex.generate_chunk(js, JA.FidelityConfig(*fid))
        tx, _ = tex.generate_chunk(ts, FidelityConfig(*fid))
        _close(tx, jx)
    assert ts.cache["len"] == js.cache["len"]
    assert ts.fidelity_log == js.fidelity_log
    assert set(tex.latency_ema) == set(jex.latency_ema)


def test_sequential_session_bit_identical_to_executor():
    """Chunks served through the session equal the eager executor's
    (same params, same draws) bit for bit."""
    cfg = _cfgs(n_layers=2, ardit_window_chunks=2)[1]
    fid = FidelityConfig(2, 0.0, 2, "bf16")
    ex = TE.SequentialChunkExecutor(cfg=cfg, device="cpu")
    sess = TS.StreamingSession(
        TS.SessionConfig(executor="sequential", verbose=False,
                         device="cpu"),
        executor=ex, fidelity_policy=StaticFidelity(fid))
    sess.submit(StreamSpec(0, 0.0, 2 * cm.PIXEL_FRAMES_PER_CHUNK))
    sess.run()
    assert sess.handles[0].done
    assert not ex.streams.get(-1) and -1 not in ex.chunks   # warm-up gone

    ref = TE.ChunkExecutor(cfg=cfg, params=ex.params, device="cpu")
    st = ref.open_stream(0, 2, now=0.0, ttfc_slack=1e9, seed=0)
    for _ in range(2):
        ref.generate_chunk(st, fid)
    for c in range(2):
        assert torch.equal(sess.handles[0].chunks[c], st.chunks[c])
    served = sess.served_streams()[0]
    assert served.cache is not None and served.cond is not None


def _run_backend(cfg, p, backend, schedule):
    """Drive a batched executor through ``schedule`` = list of (sids,
    fid) rounds, each running its streams to completion stepped
    together; returns the generated chunks."""
    ex = TB.BatchedChunkExecutor(cfg=cfg, params=p, max_streams=4,
                                 context_backend=backend, device="cpu")
    admitted = set()
    for sids, fid in schedule:
        for sid in sids:
            if sid not in admitted:
                assert ex.admit(sid, seed=sid)
                admitted.add(sid)
            ex.begin_chunk(sid, fid, 0.0)
        while any(sid in ex.inflight for sid in sids):
            ex.run_step([sid for sid in sids if sid in ex.inflight])
    return ex, {sid: [c.numpy() for c in ex.chunks[sid]]
                for sid in admitted}


@pytest.mark.parametrize("fids", [
    [(2, 0.0, 2, "bf16")],
    [(2, 0.0, 2, "bf16"), (2, 0.9, 1, "fp8"), (2, 0.6, 2, "bf16"),
     (2, 0.0, 2, "bf16")],                       # masks, fp8, ring wrap
], ids=["single-chunk", "matrix"])
def test_paged_backend_matches_gather(fids):
    cfg = _cfgs(n_layers=2, ardit_window_chunks=2)[1]
    p = TA.open_gates(TA.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu"),
                      torch.Generator().manual_seed(1))
    schedule = [([0, 1], FidelityConfig(*f)) for f in fids]
    exp, paged = _run_backend(cfg, p, "paged", schedule)
    exg, gather = _run_backend(cfg, p, "gather", schedule)
    assert exp.dispatch_count == exg.dispatch_count
    for sid in paged:
        assert len(paged[sid]) == len(gather[sid]) == len(fids)
        for a, b in zip(paged[sid], gather[sid]):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("argv,label", [
    ([], "real-sequential"),
    (["--batched", "--context-backend", "gather"], "real-batched"),
])
def test_launcher_serves_on_the_cpu(monkeypatch, capsys, argv, label):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--real", "--device", "cpu", "--streams", "2",
        "--chunks", "1", "--arrival-scale", "0.05", *argv])
    serve.main()
    out = capsys.readouterr().out
    assert f"{label} on steady: QoE=" in out
    assert out.count("chunk 1/1") == 2
