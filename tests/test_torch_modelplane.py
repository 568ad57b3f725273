"""The port's model plane (``serve/modelplane.py``, ``LanePool(bundles=)``,
``compose_batch(model_of=)`` and the session's co-serving) against the
JAX package's.

* Bundle geometry, ``page_bytes`` (bf16 and fp32 pools, from the torch
  dtype's item size) and the normalized placement weights equal the
  reference's, at the reduced and the full-width configs.
* ``compose_batch(model_of=)`` groups equal the reference's.
* A 2-model co-serve session (2-layer reduced configs, each bundle's
  params from JAX with the adaLN gates opened) is within 1e-5 of the
  reference's co-serve session, with per-model Summary rows; a
  single-bundle session is bit-identical to the ``model_cfg`` session in
  torch; migration is routed same-model-only.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs.base import get_config as jget_config
from repro.core.bmpr import StaticFidelity as JStatic
from repro.core.fidelity import FidelityConfig as JFid
from repro.models import ardit as JA
from repro.sched_sim.metrics import summarize as jsummarize
from repro.serve import modelplane as JM
from repro.serve.batcher import compose_batch as jcompose
from repro.serve.session import SessionConfig as JConfig
from repro.serve.session import StreamingSession as JSession
from repro_torch.configs.base import get_config
from repro_torch.core.bmpr import StaticFidelity as TStatic
from repro_torch.core.fidelity import FidelityConfig as TFid
from repro_torch.models.convert import params_from_numpy
from repro_torch.sched_sim.metrics import summarize
from repro_torch.serve import batcher as TB
from repro_torch.serve import modelplane as TM
from repro_torch.serve import session as TS
from repro_torch.serve.lanes import LanePool

from test_torch_batcher import inject_jax_draws  # noqa: F401

torch.set_num_threads(2)

MODELS = ["ardit-self-forcing", "ardit-causal-forcing"]
FID = (2, 0.0, 2, "bf16")


def _small(get, name):
    return dataclasses.replace(get(name).reduced(), n_layers=2,
                               ardit_window_chunks=2)


_JAX_INIT = JA.init_params


def _opened_init(cfg, key):
    """The reference's ``init_params`` with the adaLN gates opened (as
    ``test_batcher.nondegenerate_params``), keyed per model so the two
    co-served bundles differ."""
    key = jax.random.fold_in(key, MODELS.index(
        cfg.name[:-len("-reduced")] if cfg.name.endswith("-reduced")
        else cfg.name))
    p = _JAX_INIT(cfg, key)
    ks = jax.random.split(jax.random.PRNGKey(1234), 3)
    p["layers"]["mod"] = 0.2 * jax.random.normal(
        ks[0], p["layers"]["mod"].shape, p["layers"]["mod"].dtype)
    p["layers"]["mod_b"] = 0.5 + 0.2 * jax.random.normal(
        ks[1], p["layers"]["mod_b"].shape, p["layers"]["mod_b"].dtype)
    p["final_mod"] = 0.2 * jax.random.normal(
        ks[2], p["final_mod"].shape, p["final_mod"].dtype)
    return p


@pytest.fixture
def opened_jax_init(monkeypatch):
    monkeypatch.setattr(JA, "init_params", _opened_init)


def _torch_bundles(names, seed=0, **kw):
    """Bundles of the port on the CPU over the JAX params of the same
    configs (``_opened_init`` with ``PRNGKey(seed)``)."""
    out = []
    for name in names:
        jcfg = _small(jget_config, name)
        jp = _opened_init(jcfg, jax.random.PRNGKey(seed))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
        out.append(TM.resolve_bundle(_small(get_config, name), params=tp,
                                     device="cpu", **kw))
    return out


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("order", [MODELS, MODELS[::-1]])
def test_bundle_geometry_and_weights_match_jax(reduced, order):
    def geom(mod, get):
        cfgs = [get(m).reduced() if reduced else get(m) for m in order]
        if mod is TM:
            # empty params: the geometry needs no weights
            bundles = TM.resolve_bundles([TM.resolve_bundle(
                c, params={}, device="cpu") for c in cfgs])
        elif reduced:
            bundles = JM.resolve_bundles(cfgs)
        else:
            # the reference's normalization over bundles without weights
            # (no full-width init on the host)
            bundles = [JM.resolve_bundle(c, params={}) for c in cfgs]
            for b in bundles:
                b.step_cost = b.step_cost / (bundles[0].step_cost or 1.0)
                b.page_cost = float(b.page_bytes) / bundles[0].page_bytes
        return [(b.name, b.page_tokens, b.pages_per_stream, b.kv_dtype,
                 b.page_bytes, b.stream_bytes, b.step_cost, b.page_cost,
                 b.placement_weight, b.profile.model) for b in bundles]
    got, want = geom(TM, get_config), geom(JM, jget_config)
    assert got == want
    if not reduced:
        # full width: 30 layers x 2,640 tokens x 1,536 x 2 B per page
        assert got[0][4] == 30 * 2640 * 1536 * 2


def test_resolve_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        TM.resolve_bundles([])
    with pytest.raises(ValueError):
        TM.resolve_bundles(["ardit-self-forcing"] * 2, device="cpu")
    with pytest.raises(ValueError):
        TM.resolve_bundle("mamba2-780m", device="cpu")
    assert TM.profile_name_of("ardit-causal-forcing") == "causal-forcing"
    assert TM.profile_name_of("mamba2-780m") == "mamba2-780m"
    assert TM.PROFILE_NAME == JM.PROFILE_NAME


def test_bundle_init_is_the_executor_init():
    """A bundle without params draws them as the executor does from the
    same seed (registry ``init`` with a ``torch.Generator``)."""
    b = TM.resolve_bundle("ardit-causal-forcing", seed=3, device="cpu")
    ex = TB.BatchedChunkExecutor(cfg=b.cfg, seed=3, max_streams=1,
                                 device="cpu")
    flat = jax.tree_util.tree_leaves
    assert all(torch.equal(a, c) for a, c in zip(flat(b.params),
                                                 flat(ex.params)))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("fuse", [False, True])
def test_compose_batch_model_groups_match_jax(seed, fuse):
    rnd = random.Random(seed)
    sids = rnd.sample(range(40), 12)
    fids = [(2, 0.0, 2, "bf16"), (4, 0.0, 7, "bf16"), (2, 0.5, 3, "fp8"),
            (3, 0.0, 7, "fp8", "aggressive")]
    fid_of = {s: rnd.choice(fids) for s in sids}
    model_of = {s: rnd.choice(MODELS) for s in sids}
    for mb in (4, 8, 12):
        for m_of in (None, model_of.get):
            got = TB.compose_batch(sids, lambda s: TFid(*fid_of[s]), mb,
                                   fuse=fuse, model_of=m_of)
            want = jcompose(sids, lambda s: JFid(*fid_of[s]), mb,
                            fuse=fuse, model_of=m_of)
            assert got == want
            if m_of is not None:
                assert all(len({model_of[s] for s in g}) == 1 for g in got)


# ---------------------------------------------------------------------------
# co-serve sessions
# ---------------------------------------------------------------------------

def _tagged(n, chunks, names):
    return [dataclasses.replace(sp, model=names[i % len(names)])
            for i, sp in enumerate(TS.uniform_specs(n, chunks))]


@pytest.mark.slow
def test_co_serve_session_matches_jax(inject_jax_draws, opened_jax_init,
                                      monkeypatch):
    """2 models x 2 streams x 2 chunks: every stream's chunks within 1e-5
    of the reference's co-serve session, zero unserved streams, every
    sub-batch same-model, per-model Summary rows."""
    js = JSession(JConfig(executor="batched", verbose=False, pool_streams=4,
                          models=[_small(jget_config, m) for m in MODELS]),
                  fidelity_policy=JStatic(JFid(*FID)))
    ts = TS.StreamingSession(
        TS.SessionConfig(executor="batched", verbose=False, pool_streams=4,
                         models=_torch_bundles(MODELS), device="cpu"),
        fidelity_policy=TStatic(TFid(*FID)))
    groups = []
    orig = TS.compose_batch

    def spy(*a, **kw):
        out = orig(*a, **kw)
        groups.extend(out)
        return out

    monkeypatch.setattr(TS, "compose_batch", spy)
    for a, b in zip(_tagged(4, 2, MODELS), _tagged(4, 2, MODELS)):
        js.submit(a)
        ts.submit(b)
    jr, tr = js.run(), ts.run()
    tsum, jsum = summarize(tr), jsummarize(jr)
    assert tsum.n_unserved == 0 and tsum.n_chunks == 8
    assert set(tsum.by_model) == set(MODELS) == set(jsum.by_model)
    for m in MODELS:
        assert tsum.by_model[m]["n_streams"] == 2
        assert tsum.by_model[m]["n_chunks"] == 4
    assert groups and all(
        len({ts.lanes.model_of[s] for s in g}) == 1 for g in groups)
    worst = 0.0
    for sid in range(4):
        tc = [c.numpy() for c in ts.handles[sid].chunks]
        jc = [np.asarray(c) for c in js.handles[sid].chunks]
        assert len(tc) == len(jc) == 2
        for a, b in zip(tc, jc):
            worst = max(worst, float(np.abs(a - b).max()))
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    print(f"max |latent diff| = {worst:.3g}")
    # the two models' streams really ran different weights
    assert not np.allclose(ts.handles[0].chunks[0].numpy(),
                           ts.handles[1].chunks[0].numpy())
    # each bundle calibrated on its own warm-up chunk and executors
    for b in ts.bundles:
        assert b.top_latency > 0.0
        exs = ts.lanes.bundle_executors[b.name]
        assert all(FID_KEY in ex.latency_ema for ex in exs)


FID_KEY = TFid(*FID).key


@pytest.mark.slow
def test_single_bundle_session_degenerates_to_legacy(inject_jax_draws):
    """``models=[one config]`` gives chunks bit-identical to the
    ``model_cfg`` single-model session (same seeds, fixed fidelity)."""
    cfg = _small(get_config, "ardit-causal-forcing")
    out = []
    for kw in (dict(models=[cfg]), dict(model_cfg=cfg)):
        sess = TS.StreamingSession(
            TS.SessionConfig(executor="batched", pool_streams=4,
                             verbose=False, device="cpu", **kw),
            fidelity_policy=TStatic(TFid(*FID)))
        hs = [sess.submit(sp) for sp in TS.uniform_specs(2, 2)]
        sess.run()
        out.append([[c.clone() for c in h.chunks] for h in hs])
    for a, b in zip(*out):
        assert len(a) == len(b) == 2
        for ca, cb in zip(a, b):
            assert torch.equal(ca, cb)


@pytest.mark.slow
def test_same_model_only_migration_routing(inject_jax_draws):
    bundles = TM.resolve_bundles(_torch_bundles(MODELS))
    lanes = LanePool(2, max_streams=4, bundles=bundles, device="cpu")
    other = MODELS[1]
    lanes.admit(0, 0, seed=0, model=other)
    ex_src, ex_dst = lanes.ex_for(0, other), lanes.ex_for(1, other)
    assert ex_src is lanes.bundle_executors[other][0]
    assert ex_src is not lanes.ex(0)
    assert lanes.ex_for(1, None) is lanes.ex(1)
    assert len(lanes.all_executors) == 4
    ex_src.begin_chunk(0, TFid(*FID), 0.0)
    while 0 in ex_src.inflight:
        ex_src.run_step([0])
    before = ex_src.pool.gather([0], 1)
    before = (before[0].clone(), before[1].clone())
    assert lanes.migrate(0, 0, 1)
    assert ex_dst.pool.resident(0) and not ex_src.pool.resident(0)
    after = ex_dst.pool.gather([0], 1)
    assert torch.equal(after[0], before[0]) and \
        torch.equal(after[1], before[1])
    # the primary bundle's pools never saw the stream
    assert not lanes.ex(0).pool.resident(0)
    assert not lanes.ex(1).pool.resident(0)
    assert lanes.model_of[0] == other and lanes.lane_of[0] == 1
    assert lanes.executor_of(0) is ex_dst
    # an SP expand mirrors into the donor lane's pool of the same model
    assert lanes.sp_expand(0, 0)
    assert lanes.sp_link(0).pool is ex_src.pool
    lanes.sp_release(0)
    lanes.retire(0)
    assert lanes.model_of[0] == other        # chunks stay readable
    assert len(lanes.chunks_of(0)) == 1


def test_latency_emas_are_scoped_per_model():
    bundles = TM.resolve_bundles(_torch_bundles(MODELS))
    lanes = LanePool(1, max_streams=2, bundles=bundles, device="cpu")
    lanes.ex(0).latency_ema["k"] = 1.0
    lanes.ex_for(0, MODELS[1]).latency_ema["k"] = 3.0
    assert lanes.latency_ema_get("k", 0.0) == 1.0
    assert lanes.latency_ema_get("k", 0.0, model=MODELS[1]) == 3.0
    assert lanes.latency_ema_get("x", 7.0, model=MODELS[1]) == 7.0
