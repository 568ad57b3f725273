"""The port's ``BatchedChunkExecutor`` against the JAX reference's,
driven by the same admit / begin_chunk / run_step sequence on the same
params and the same injected conditioning and noise.

Scenarios: fused mixed-fidelity dispatch (steps 2/4, window 1/2, rho
0/0.9, bf16 and fp8 groups) with a stream joining mid-chunk and others
leaving, and a 2x-oversubscribed pool under ``page_evict`` (page-wise
degradation plus whole-stream spill/restore).  Every chunk's latents,
``dispatch_count``, the page-ledger tables and the counters must agree.
Tolerance: 1e-4 (rtol and atol) on the latents of these multi-chunk
runs, whose fp32 differences compound through the KV appended by each
chunk; the measured maximum is printed.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.fidelity import FidelityConfig as JFid
from repro.core.types import Stream as JStream
from repro.serve.batcher import BatchedChunkExecutor as JEx
from repro_torch.core.fidelity import FidelityConfig as TFid
from repro_torch.core.types import Stream as TStream
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import batcher as TB

from test_batcher import nondegenerate_params, tiny_cfg
from test_torch_layers import _cfgs

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def jax_cond(seed, d_model):
    """The reference executor's conditioning draw, as a torch tensor."""
    key = jax.random.PRNGKey(1000 + seed)
    return torch.from_numpy(np.array(
        jax.random.normal(key, (1, 77, d_model)) * 0.02))


def jax_noise(chunk_seq, sid, tc):
    """The reference executor's chunk-noise draw, as a torch tensor."""
    key = jax.random.PRNGKey(chunk_seq * 7919 + sid)
    return torch.from_numpy(np.array(jax.random.normal(key, (1, tc, 16))))


@pytest.fixture
def inject_jax_draws(monkeypatch):
    monkeypatch.setattr(TB, "cond_noise", jax_cond)
    monkeypatch.setattr(TB, "chunk_noise", jax_noise)


def _pair(window_chunks, max_streams, page_evict=False):
    jcfg, tcfg = _cfgs(n_layers=2, ardit_window_chunks=window_chunks)
    assert jcfg == tiny_cfg(window_chunks)
    jp = nondegenerate_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jex = JEx(cfg=jcfg, params=jp, max_streams=max_streams,
              page_evict=page_evict)
    tex = TB.BatchedChunkExecutor(cfg=tcfg, params=tp,
                                  max_streams=max_streams, device="cpu",
                                  page_evict=page_evict)
    return jex, tex


def _credit(cls, sids, ex):
    out = {}
    for sid in sids:
        out[sid] = cls(sid=sid, arrival=0.0, target_chunks=3,
                       chunk_seconds=1.0, home=0, ttfc_slack=1e9)
        out[sid].credit = float(len(ex.chunks.get(sid, ())))
    return out


def _compare(jex, tex):
    assert tex.dispatch_count == jex.dispatch_count
    assert set(tex.chunks) == set(jex.chunks)
    worst = 0.0
    for sid in jex.chunks:
        assert len(tex.chunks[sid]) == len(jex.chunks[sid]), sid
        for c, (a, b) in enumerate(zip(tex.chunks[sid], jex.chunks[sid])):
            a, b = a.numpy(), np.asarray(b)
            worst = max(worst, float(np.abs(a - b).max()))
            np.testing.assert_allclose(a, b, err_msg=f"stream {sid} "
                                       f"chunk {c}", **TOL)
        assert tex.fidelity_log[sid] == jex.fidelity_log[sid]
        assert tex.effective_window_log[sid] == \
            jex.effective_window_log[sid]
    tl, jl = tex.pool.ledger, jex.pool.ledger
    assert set(tl.tables) == set(jl.tables)
    for sid in jl.tables:
        np.testing.assert_array_equal(tl.tables[sid], jl.tables[sid])
    assert tl.chunks == jl.chunks and tl.dropped == jl.dropped
    assert tl._free == jl._free and tl.spilled == jl.spilled
    for name in ("evictions", "restores", "deferrals", "page_evictions"):
        assert getattr(tex, name) == getattr(jex, name), name
    assert tex.pool.transfer_bytes == jex.pool.transfer_bytes
    print(f"max |latent diff| = {worst:.3g}")
    return worst


def test_mixed_fidelity_join_leave_matches_jax(inject_jax_draws):
    """Fused dispatch over four fidelities in two dtype groups; stream 3
    joins while the others are mid-chunk, streams leave (retire) as they
    finish, and the ring wraps (3 chunks over a 2-chunk window)."""
    jex, tex = _pair(window_chunks=2, max_streams=4)
    fids = {0: (2, 0.0, 2, "bf16"), 1: (4, 0.9, 1, "bf16"),
            2: (2, 0.0, 1, "fp8"), 3: (4, 0.9, 2, "fp8")}
    target = {0: 3, 1: 2, 2: 3, 3: 2}
    active = []
    for rnd in range(40):
        joins = [0, 1, 2] if rnd == 0 else [3] if rnd == 2 else []
        for sid in joins:
            assert jex.admit(sid, seed=sid) and tex.admit(sid, seed=sid)
            active.append(sid)
        for sid in active:
            if sid not in jex.inflight:
                jex.begin_chunk(sid, JFid(*fids[sid]), 0.0)
                tex.begin_chunk(sid, TFid(*fids[sid]), 0.0)
        groups = TB.compose_batch(active, lambda s: TFid(*fids[s]), 4,
                                  fuse=True)
        for grp in groups:
            jdone, _ = jex.run_step(grp)
            tdone, _ = tex.run_step(grp)
            assert tdone == jdone
        for sid in list(active):
            if len(jex.chunks[sid]) == target[sid]:
                jex.retire(sid)
                tex.retire(sid)
                active.remove(sid)
        if not active:
            break
    assert not active
    assert len(jex.chunks[3]) == 2
    _compare(jex, tex)


def test_oversubscribed_page_evict_matches_jax(inject_jax_draws):
    """2x oversubscription with the page-eviction ladder: single ring
    pages are discarded first, whole streams spill and restore, and the
    port stays on the reference's trajectory and page ledger."""
    jex, tex = _pair(window_chunks=3, max_streams=2, page_evict=True)
    fid = (2, 0.0, 3, "bf16")
    n, chunks = 4, 3
    jst, tst = _credit(JStream, range(n), jex), _credit(TStream, range(n), tex)
    for sid in range(n):
        assert jex.admit(sid, seed=sid, streams=jst) == \
            tex.admit(sid, seed=sid, streams=tst)
    assert tex.page_evictions >= 1
    while any(len(jex.chunks[s]) < chunks for s in range(n)):
        for sid in range(n):
            jst[sid].credit = tst[sid].credit = float(len(jex.chunks[sid]))
        runnable = sorted((s for s in range(n)
                           if len(jex.chunks[s]) < chunks),
                          key=lambda s: (jst[s].credit, s))
        batch = []
        for sid in runnable:
            ok = jex.ensure_resident(sid, jst, protect=batch + [sid])
            assert tex.ensure_resident(sid, tst,
                                       protect=batch + [sid]) == ok
            if ok:
                batch.append(sid)
            if len(batch) >= 2:
                break
        assert batch
        for sid in batch:
            if sid not in jex.inflight:
                jex.begin_chunk(sid, JFid(*fid), 0.0)
                tex.begin_chunk(sid, TFid(*fid), 0.0)
        assert tex.run_step(batch)[0] == jex.run_step(batch)[0]
        tex.pool.ledger.check()
    assert tex.evictions > 0 and tex.restores > 0
    _compare(jex, tex)


def test_waiting_paths_raise():
    cfg = _cfgs(n_layers=2)[1]
    with pytest.raises(ValueError):
        TB.BatchedChunkExecutor(cfg=cfg, device="cpu",
                                context_backend="gathered")
    ex = TB.BatchedChunkExecutor(cfg=cfg, device="cpu", max_streams=1)
    ex.admit(0, seed=0)
    with pytest.raises(NotImplementedError):
        ex.begin_chunk(0, TFid(2, 0.0, 2, "bf16", "aggressive"), 0.0)
