"""The port's ``StreamingSession`` against the JAX reference's, both under
``StaticFidelity`` with the same params and the same injected
conditioning and noise (the reference's own draws): every stream's
chunks must agree, and both sessions report the same Summary counts.
A second case oversubscribes the page pool so credit-aware eviction and
restore run inside the session loop; a third serves through the
sequential executor.  Tolerance 1e-4 (rtol and atol),
measured maximum printed.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.bmpr import StaticFidelity as JStatic
from repro.core.fidelity import FidelityConfig as JFid
from repro.sched_sim.metrics import summarize as jsummarize
from repro.serve.batcher import BatchedChunkExecutor as JEx
from repro.serve.executor import SequentialChunkExecutor as JSeq
from repro.serve.session import SessionConfig as JConfig
from repro.serve.session import StreamingSession as JSession
from repro.serve.session import uniform_specs as juniform
from repro_torch.core.bmpr import StaticFidelity as TStatic
from repro_torch.core.fidelity import FidelityConfig as TFid
from repro_torch.models.convert import params_from_numpy
from repro_torch.sched_sim.metrics import summarize as tsummarize
from repro_torch.serve import batcher as TB
from repro_torch.serve import executor as TE
from repro_torch.serve import session as TS

from test_batcher import nondegenerate_params
from test_torch_batcher import inject_jax_draws  # noqa: F401
from test_torch_batcher import jax_cond, jax_noise
from test_torch_layers import _cfgs

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
FID = (2, 0.0, 2, "bf16")


@pytest.mark.parametrize("n,chunks,max_batch,pool", [
    (2, 2, 4, 3),          # everyone resident, one fused batch
    (3, 2, 2, 2),          # oversubscribed pool: spill / restore
])
def test_session_chunks_match_jax(inject_jax_draws, n, chunks, max_batch,
                                  pool):
    jcfg, tcfg = _cfgs(n_layers=2, ardit_window_chunks=2)
    jp = nondegenerate_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))

    js = JSession(JConfig(verbose=False, max_batch=max_batch),
                  executor=JEx(cfg=jcfg, params=jp, max_streams=pool),
                  fidelity_policy=JStatic(JFid(*FID)))
    ts = TS.StreamingSession(
        TS.SessionConfig(verbose=False, max_batch=max_batch, device="cpu"),
        executor=TB.BatchedChunkExecutor(cfg=tcfg, params=tp,
                                         max_streams=pool, device="cpu"),
        fidelity_policy=TStatic(TFid(*FID)))
    for a, b in zip(juniform(n, chunks), TS.uniform_specs(n, chunks)):
        js.submit(a)
        ts.submit(b)
    jr, tr = js.run(), ts.run()

    worst = 0.0
    for sid in range(n):
        jc = [np.asarray(c) for c in js.handles[sid].chunks]
        tc = [c.numpy() for c in ts.handles[sid].chunks]
        assert len(tc) == len(jc) == chunks
        assert ts.handles[sid].done
        for a, b in zip(tc, jc):
            worst = max(worst, float(np.abs(a - b).max()))
            np.testing.assert_allclose(a, b, **TOL)
        assert ts.handles[sid].fidelity_log == js.handles[sid].fidelity_log
    print(f"max |latent diff| = {worst:.3g}")
    tsum, jsum = tsummarize(tr), jsummarize(jr)
    assert (tsum.n_streams, tsum.n_chunks) == (jsum.n_streams, jsum.n_chunks)
    assert tr.fidelity_counts == jr.fidelity_counts
    if pool < n:
        assert ts.executor.evictions > 0 and ts.executor.restores > 0


def test_session_waiting_options_raise():
    for kw in (dict(models=["ardit-self-forcing"]), dict(step_cache=True)):
        with pytest.raises(NotImplementedError):
            TS.StreamingSession(TS.SessionConfig(device="cpu", **kw))


def test_session_sequential_matches_jax(inject_jax_draws, monkeypatch):
    """``executor="sequential"`` (whole chunks, one stream per step)
    against the reference's sequential session: same chunks, fidelity
    logs and Summary counts."""
    monkeypatch.setattr(TE, "cond_noise", jax_cond)
    monkeypatch.setattr(TE, "chunk_noise", jax_noise)
    jcfg, tcfg = _cfgs(n_layers=2, ardit_window_chunks=2)
    jp = nondegenerate_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    js = JSession(JConfig(executor="sequential", verbose=False),
                  executor=JSeq(cfg=jcfg, params=jp),
                  fidelity_policy=JStatic(JFid(*FID)))
    ts = TS.StreamingSession(
        TS.SessionConfig(executor="sequential", verbose=False,
                         device="cpu"),
        executor=TE.SequentialChunkExecutor(cfg=tcfg, params=tp,
                                            device="cpu"),
        fidelity_policy=TStatic(TFid(*FID)))
    for a, b in zip(juniform(2, 2), TS.uniform_specs(2, 2)):
        js.submit(a)
        ts.submit(b)
    jr, tr = js.run(), ts.run()
    for sid in range(2):
        tc = [c.numpy() for c in ts.handles[sid].chunks]
        jc = [np.asarray(c) for c in js.handles[sid].chunks]
        assert len(tc) == len(jc) == 2 and ts.handles[sid].done
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a, b, **TOL)
        assert ts.handles[sid].fidelity_log == js.handles[sid].fidelity_log
    tsum, jsum = tsummarize(tr), jsummarize(jr)
    assert (tsum.n_streams, tsum.n_chunks) == (jsum.n_streams, jsum.n_chunks)
    # the default config builds its own sequential executor
    own = TS.StreamingSession(TS.SessionConfig(
        executor="sequential", verbose=False, device="cpu",
        model_cfg=tcfg), fidelity_policy=TStatic(TFid(*FID)))
    assert isinstance(own.executor, TE.SequentialChunkExecutor)
    assert own.executor.cfg == tcfg
