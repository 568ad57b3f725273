"""The port's step cache (``models/stepcache.py`` and the batched
executor's cache rows) against the JAX package's.

* ``StepCacheManager`` fed the same velocity and KV sequences makes the
  same hit / miss decisions as the reference's, with deltas within 1e-6
  relative (a failure names the smallest margin to a threshold).
* ``_record`` and ``_apply_cached`` at fp32 and bf16: the same values
  and result dtypes (the velocity bit for bit, the KV signature within
  1 ulp of its dtype, the delta within 1e-6 relative, the hit AXPY bit
  for bit: XLA contracts it to one multiply-add, as ``torch.add`` with
  ``alpha`` does).
* The batched executor under ``aggressive`` against the reference
  executor: the same hits, misses and skipped launches, chunks within
  1e-5; and the reference's executor checks ported to torch (cache off
  never builds the manager, a cache row leaves its off neighbours bit
  exact, export / retire drop cache state mid-run), plus a session
  with ``step_cache=True`` against the reference's session.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.core.bmpr import StaticFidelity as JStatic
from repro.core.fidelity import FidelityConfig as JFid
from repro.models import stepcache as JS
from repro.serve.batcher import BatchedChunkExecutor as JEx
from repro.serve.batcher import compose_batch as jcompose
from repro.serve.session import SessionConfig as JConfig
from repro.serve.session import StreamingSession as JSession
from repro.serve.session import uniform_specs as juniform
from repro_torch.core.bmpr import StaticFidelity as TStatic
from repro_torch.core.fidelity import FidelityConfig as TFid
from repro_torch.models import stepcache as TSC
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import batcher as TB
from repro_torch.serve import session as TS

from test_batcher import nondegenerate_params
from test_torch_batcher import inject_jax_draws  # noqa: F401
from test_torch_layers import _cfgs

torch.set_num_threads(2)

OFF = (4, 0.0, 3, "bf16")
AGG = OFF + ("aggressive",)
CON = OFF + ("conservative",)


# ---------------------------------------------------------------------------
# the tracker: decisions and deltas
# ---------------------------------------------------------------------------

def _sequence(seed, n_steps, tokens=24, ch=4, layers=3, drift=0.3,
              jump_at=None):
    """Per-step (velocity, k) pairs: a base field drifting by ``drift``
    relative per step, with a jump at ``jump_at``."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, tokens, ch)).astype(np.float32)
    kb = rng.normal(size=(layers, tokens, 2, 4)).astype(np.float32)
    out = []
    for i in range(n_steps):
        scale = 6.0 if i == jump_at else 1.0
        v = base * scale + drift * rng.normal(size=base.shape)
        k = kb + drift * rng.normal(size=kb.shape)
        out.append((v.astype(np.float32), k.astype(np.float32)))
    return out


def _drive_manager(mod, to_dev, seqs, level, history, dt, **dev):
    """Run one stream through ``mod.StepCacheManager`` for the steps of
    ``seqs``: each step asks ``should_hit``; a hit applies the cached
    AXPY, a miss records the computed step.  Returns (decisions, deltas
    seen at each decision, the final latents)."""
    _, tokens, ch = seqs[0][0].shape
    mgr = mod.StepCacheManager(2, tokens, ch, seqs[0][1].shape[0], **dev)
    mgr.begin_chunk(0, None if history is None
                    else [to_dev(h) for h in history])
    x = to_dev(np.zeros((1, tokens, ch), np.float32))
    decisions, deltas = [], []
    for v, k in seqs:
        st = mgr.states[0]
        deltas.append(None if st.delta is None else float(st.delta))
        hit = mgr.should_hit(0, level)
        decisions.append(hit)
        if hit:
            x = mgr.apply_hit(0, x, dt)
        else:
            x_new = x - dt * to_dev(v)
            mgr.record_step(0, x, x_new, dt, to_dev(k))
            x = x_new
    return decisions, deltas, mgr.stats(), np.asarray(x), mgr


CASES = {
    "stable-aggressive": (dict(seed=0, n_steps=9, drift=0.05),
                          "aggressive", None, 0.25),
    "stable-conservative": (dict(seed=1, n_steps=9, drift=0.01),
                            "conservative", None, 0.25),
    "drifting-conservative": (dict(seed=2, n_steps=9, drift=0.03),
                              "conservative", None, 1 / 3),
    "jump-aggressive": (dict(seed=3, n_steps=10, drift=0.1, jump_at=4),
                        "aggressive", None, 0.5),
    "motion-history": (dict(seed=4, n_steps=9, drift=0.04), "aggressive",
                       "moving", 1 / 3),
    "static-history": (dict(seed=5, n_steps=9, drift=0.2), "aggressive",
                       "static", 1 / 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_manager_decisions_match_jax(case):
    kw, level, hist, dt = CASES[case]
    seqs = _sequence(**kw)
    history = None
    if hist is not None:
        rng = np.random.default_rng(99)
        a = rng.normal(size=(1, 24, 4)).astype(np.float32)
        b = a + (3.0 if hist == "moving" else 0.0) * rng.normal(
            size=a.shape).astype(np.float32)
        history = [a, b]
    td, tdel, tstats, tx, tm = _drive_manager(
        TSC, lambda a: torch.from_numpy(np.array(a)), seqs, level,
        history, dt, device="cpu")
    jd, jdel, jstats, jx, jm = _drive_manager(JS, jnp.asarray, seqs, level,
                                              history, dt)
    assert tm.states[0].motion == pytest.approx(jm.states[0].motion,
                                                rel=1e-6)
    thr = tm.effective_threshold(level, tm.states[0].motion)
    margins = [abs(d - thr) / thr for d in jdel if d is not None]
    msg = (f"{case}: torch {td} vs jax {jd}; smallest margin to the "
           f"threshold {min(margins) if margins else None}")
    assert td == jd, msg
    assert tstats == jstats
    assert any(td) and not all(td), msg      # both decisions exercised
    for a, b in zip(tdel, jdel):
        assert (a is None) == (b is None)
        if a is not None:
            assert a == pytest.approx(b, rel=1e-6, abs=1e-12), msg
    np.testing.assert_allclose(tx, jx, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the two device functions, fp32 and bf16
# ---------------------------------------------------------------------------

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("steps", [2, 3, 4])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_record_matches_jax(dtype, steps):
    jdt, tdt = _DT[dtype]
    dt = 1.0 / steps
    rng = np.random.default_rng(steps)
    xo = rng.normal(size=(1, 96, 16)).astype(np.float32)
    xn = rng.normal(size=(1, 96, 16)).astype(np.float32)
    k = rng.normal(size=(3, 96, 2, 8)).astype(np.float32)
    vp = rng.normal(size=(3, 1, 96, 16)).astype(np.float32)
    fp = rng.normal(size=(3, 3)).astype(np.float32)
    jv, jf, jd = JS._record(jnp.asarray(vp), jnp.asarray(fp), jnp.int32(2),
                            jnp.asarray(xo).astype(jdt),
                            jnp.asarray(xn).astype(jdt), dt,
                            jnp.asarray(k).astype(jdt))
    tv, tf = torch.from_numpy(vp.copy()), torch.from_numpy(fp.copy())
    td = TSC._record(tv, tf, 2, torch.from_numpy(xo).to(tdt),
                     torch.from_numpy(xn).to(tdt),
                     torch.tensor(dt, dtype=torch.float32),
                     torch.from_numpy(k).to(tdt))
    assert tv.dtype == torch.float32 and tf.dtype == torch.float32
    assert td.dtype == torch.float32 and jd.dtype == jnp.float32
    assert td.dim() == 0
    # the velocity row bit for bit; the other slots untouched
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tv.numpy()[:2], vp[:2])
    # the KV signature: a mean in k's dtype (order of summation only)
    want_f = np.asarray(jf)
    tol = (_bf16_ulp(want_f) if dtype == "bfloat16"
           else 1e-6 * np.abs(want_f))
    assert np.all(np.abs(tf.numpy() - want_f) <= tol)
    assert float(td) == pytest.approx(float(jd), rel=1e-6)


@pytest.mark.parametrize("steps", [2, 3, 4])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_apply_cached_matches_jax(dtype, steps):
    jdt, tdt = _DT[dtype]
    dt = 1.0 / steps
    rng = np.random.default_rng(10 + steps)
    x = rng.normal(size=(1, 96, 16)).astype(np.float32)
    vp = rng.normal(size=(3, 1, 96, 16)).astype(np.float32)
    ja = JS._apply_cached(jnp.asarray(x).astype(jdt), jnp.asarray(vp),
                          jnp.int32(1), dt)
    ta = TSC._apply_cached(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(vp), 1, dt)
    # bf16 latents promote against the fp32 pool, as in JAX
    assert ta.dtype == torch.float32 and ja.dtype == jnp.float32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


# ---------------------------------------------------------------------------
# the tracker's state machine (the reference's manager tests, in torch)
# ---------------------------------------------------------------------------

def _feed(mgr, sid, velocities, dt=0.25):
    x = torch.zeros((1, 8, 4))
    k = torch.ones((2, 8, 1, 2))
    for v in velocities:
        x_new = x - dt * v
        mgr.record_step(sid, x, x_new, dt, k)
        x = x_new


def test_manager_state_machine():
    ones = torch.ones((1, 8, 4))
    mgr = TSC.StepCacheManager(2, 8, 4, 2, device="cpu")
    mgr.begin_chunk(0, None)
    assert not mgr.should_hit(0, "aggressive")      # no delta yet
    _feed(mgr, 0, [ones, ones])
    x = torch.zeros((1, 8, 4))
    for _ in range(TSC.MAX_CONSECUTIVE["aggressive"]):
        assert mgr.should_hit(0, "aggressive")
        x = mgr.apply_hit(0, x, 0.25)
    assert not mgr.should_hit(0, "aggressive")      # cap reached
    np.testing.assert_allclose(x.numpy(), (-0.5 * ones).numpy(), rtol=1e-6)
    _feed(mgr, 0, [ones])                           # a computed step resets
    assert mgr.should_hit(0, "aggressive")
    # reset keeps the slot; drop frees it; slot exhaustion never hits
    mgr.reset_chunk(0)
    assert not mgr.should_hit(0, "aggressive")
    mgr.drop(0)
    assert 0 not in mgr.states
    mgr.begin_chunk(1, None)
    mgr.begin_chunk(2, None)
    mgr.begin_chunk(3, None)
    assert 1 in mgr.states and 2 in mgr.states and 3 not in mgr.states
    _feed(mgr, 3, [ones, ones])
    assert not mgr.should_hit(3, "aggressive")
    assert mgr.effective_threshold("aggressive", 1.0) < \
        TSC.THRESHOLDS["aggressive"] / 4


# ---------------------------------------------------------------------------
# the batched executor's cache rows
# ---------------------------------------------------------------------------

def _pair(n, window_chunks=3):
    jcfg, tcfg = _cfgs(n_layers=2, ardit_window_chunks=window_chunks)
    jp = nondegenerate_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jex = JEx(cfg=jcfg, params=jp, max_streams=n + 1)
    tex = TB.BatchedChunkExecutor(cfg=tcfg, params=tp, max_streams=n + 1,
                                  device="cpu")
    for sid in range(n):
        assert jex.admit(sid, seed=sid) and tex.admit(sid, seed=sid)
    return jex, tex


def _drive(ex, compose, fid_of, targets, max_batch=8):
    """The reference tests' ``_drive``: every runnable stream begins its
    next chunk, then one fused step per group."""
    sids = sorted(targets)
    while any(len(ex.chunks[s]) < targets[s] for s in sids):
        runnable = [s for s in sids if len(ex.chunks[s]) < targets[s]]
        for s in runnable:
            if s not in ex.inflight:
                ex.begin_chunk(s, fid_of(s), 0.0)
        for grp in compose(runnable, lambda s: ex.inflight[s].fidelity,
                           max_batch, fuse=True):
            ex.run_step(grp)


def _both(jex, tex, fid_of, targets):
    _drive(jex, jcompose, lambda s: JFid(*fid_of(s)), targets)
    _drive(tex, TB.compose_batch, lambda s: TFid(*fid_of(s)), targets)


def _close_chunks(jex, tex, sids, tol=1e-5):
    worst = 0.0
    for sid in sids:
        assert len(tex.chunks[sid]) == len(jex.chunks[sid])
        for a, b in zip(tex.chunks[sid], jex.chunks[sid]):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype
            worst = max(worst, float(np.abs(a - b).max()))
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    return worst


@pytest.mark.slow
@pytest.mark.parametrize("targets,fid_of", [
    ({0: 3}, lambda s: AGG),
    ({0: 3, 1: 3}, lambda s: AGG if s == 1 else OFF),
    ({0: 2, 1: 3}, lambda s: CON if s == 0 else AGG),
], ids=["one-stream-aggressive", "aggressive-beside-off",
        "conservative-beside-aggressive"])
def test_executor_cache_matches_jax(inject_jax_draws, targets, fid_of):
    jex, tex = _pair(len(targets))
    _both(jex, tex, fid_of, targets)
    jsc, tsc = jex.stepcache, tex.stepcache
    assert tsc.stats() == jsc.stats()
    assert tex.cache_skipped_launches == jex.cache_skipped_launches
    assert tex.dispatch_count == jex.dispatch_count
    worst = _close_chunks(jex, tex, targets)
    print(f"hits {tsc.hits}, skipped {tex.cache_skipped_launches}, "
          f"max |latent diff| {worst:.3g}")
    if targets == {0: 3}:
        assert tsc.hits > 0 and tex.cache_skipped_launches > 0
        assert set(tex.latency_ema) == {TFid(*AGG).key}


@pytest.mark.slow
def test_cache_off_never_constructs_manager(inject_jax_draws):
    _, tex = _pair(2)
    _drive(tex, TB.compose_batch, lambda s: TFid(*OFF), {0: 2, 1: 2})
    assert tex.stepcache is None
    assert tex.cache_skipped_launches == 0


@pytest.mark.slow
def test_cache_aggressive_hits_skips_launches_bounded_drift(
        inject_jax_draws):
    _, off = _pair(1)
    _, agg = _pair(1)
    _drive(off, TB.compose_batch, lambda s: TFid(*OFF), {0: 3})
    _drive(agg, TB.compose_batch, lambda s: TFid(*AGG), {0: 3})
    sc = agg.stepcache
    assert sc is not None and sc.hits > 0
    assert agg.cache_skipped_launches > 0
    assert agg.dispatch_count < off.dispatch_count
    assert 0.0 < sc.stats()["hit_rate"] <= 0.5
    for a, b in zip(agg.chunks[0], off.chunks[0]):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) < 0.5


@pytest.mark.slow
def test_cache_row_leaves_off_neighbors_bit_exact(inject_jax_draws):
    _, ref = _pair(2)
    _, mix = _pair(2)
    _drive(ref, TB.compose_batch, lambda s: TFid(*OFF), {0: 2, 1: 2})
    _drive(mix, TB.compose_batch,
           lambda s: TFid(*(AGG if s == 1 else OFF)), {0: 2, 1: 2})
    assert mix.stepcache is not None and mix.stepcache.hits > 0
    assert mix.dispatch_count == ref.dispatch_count
    for a, b in zip(mix.chunks[0], ref.chunks[0]):
        assert torch.equal(a, b)


@pytest.mark.slow
def test_export_retire_drop_cache_state_mid_run(inject_jax_draws):
    _, ex = _pair(2)
    _drive(ex, TB.compose_batch, lambda s: TFid(*AGG), {0: 1, 1: 1})
    sc = ex.stepcache
    assert 0 in sc.states and 1 in sc.states
    state = ex.export_stream(0)
    assert 0 not in sc.states
    assert "effective_window_log" in state
    ex.import_stream(0, state)
    assert 0 not in sc.states
    ex.retire(1)
    assert 1 not in sc.states
    assert ex.ensure_resident(0)
    _drive(ex, TB.compose_batch, lambda s: TFid(*AGG), {0: 3})
    assert len(ex.chunks[0]) == 3
    assert 0 in sc.states
    # spill drops the tracker too; abort keeps the slot
    ex.begin_chunk(0, TFid(*AGG), 0.0)
    ex.abort_chunk(0)
    assert 0 in sc.states and sc.states[0].n_computed == 0


@pytest.mark.slow
def test_session_step_cache_matches_jax(inject_jax_draws):
    """``step_cache=True`` under a static aggressive fidelity: the same
    chunks (1e-5) and the same ``SessionResult.step_cache`` counters as
    the reference's session; the off fidelity keeps the stats empty."""
    jcfg, tcfg = _cfgs(n_layers=2, ardit_window_chunks=2)
    jp = nondegenerate_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    out = {}
    for fid in (AGG, OFF):
        js = JSession(JConfig(verbose=False, step_cache=True),
                      executor=JEx(cfg=jcfg, params=jp, max_streams=3),
                      fidelity_policy=JStatic(JFid(*fid)))
        ts = TS.StreamingSession(
            TS.SessionConfig(verbose=False, step_cache=True, device="cpu"),
            executor=TB.BatchedChunkExecutor(cfg=tcfg, params=tp,
                                             max_streams=3, device="cpu"),
            fidelity_policy=TStatic(TFid(*fid)))
        for a, b in zip(juniform(2, 3), TS.uniform_specs(2, 3)):
            js.submit(a)
            ts.submit(b)
        jr, tr = js.run(), ts.run()
        assert tr.step_cache == jr.step_cache
        for sid in range(2):
            for a, b in zip(ts.handles[sid].chunks, js.handles[sid].chunks):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-5)
        out[fid] = tr.step_cache
    assert out[AGG]["hits"] > 0 and out[AGG]["skipped_launches"] > 0
    assert out[OFF] == {}
    # step_cache unlocks the cache levels in the default BMPR surface
    own = TS.StreamingSession(TS.SessionConfig(
        verbose=False, step_cache=True, device="cpu", model_cfg=tcfg))
    inner = own.control.fidelity_policy.inner
    assert any(p.fidelity.cache != "off" for p in inner.profile.points)
    assert dataclasses.is_dataclass(own.result())
