"""The port's simulator, baselines, calibration and ``--sim`` launcher
against the JAX package's (both are numpy-only, so they must agree
exactly).

* Every policy ``make_policy`` takes, over the ``steady``, ``burst`` and
  ``mixed_models`` workloads from one seed: identical ``Summary`` and
  identical per-stream timelines, decision counts and transfer logs;
  only the wall-clock fields (``control_tick_times``, ``tick_wall``) are
  left out.
* ``python -m repro_torch.launch.serve --sim ...`` prints what
  ``python -m repro.launch.serve --sim ...`` prints for the same
  arguments.
* The calibration fits (``fit_ratios``, ``fit_batch_alpha``,
  ``fit_cache_speedups``, ``agreement``) give equal results on equal
  inputs; then the reference's end-to-end checks on a real session of
  the port (the calibrated replay agrees within ``QOE_ABS_TOL`` /
  ``TTFC_REL_TOL``; the sim-vs-real Summary parity).
"""
import dataclasses
import math
import sys

import pytest

pytest.importorskip("torch")

import torch

from repro.launch import serve as jserve
from repro.profiler.profiles import get_profile as jget_profile
from repro.sched_sim import calibration as JC
from repro.sched_sim.metrics import summarize as jsummarize
from repro.sched_sim.policies import SDV2Policy as JSDV2
from repro.sched_sim.policies import make_policy as jmake_policy
from repro.sched_sim.simulator import SimConfig as JSimConfig
from repro.sched_sim.simulator import Simulator as JSimulator
from repro.sched_sim.workloads import WORKLOADS as JWORKLOADS
from repro_torch.launch import serve as tserve
from repro_torch.profiler.profiles import get_profile
from repro_torch.sched_sim import calibration as TC
from repro_torch.sched_sim.frontdoor import FrontDoorConfig
from repro_torch.sched_sim.metrics import (Summary, stall_histogram,
                                           summarize, transfer_stats)
from repro_torch.sched_sim.policies import SDV2Policy, make_policy
from repro_torch.sched_sim.simulator import SimConfig, Simulator
from repro_torch.sched_sim.workloads import WORKLOADS, steady
from repro_torch.serve import batcher as TB
from repro_torch.serve import session as TS

from test_torch_layers import _cfgs

torch.set_num_threads(2)

POLICIES = ("slackserve", "sdv2", "ts", "ts-chunk", "credit-only",
            "credit+bmpr", "credit+bmpr+rehome", "bmpr-fixed-level")
WORKLOAD_NAMES = ("steady", "burst", "mixed_models")
N_STREAMS = 80


def _run(sim_mod, name, wl):
    """One seeded run of ``sim_mod``'s simulator: (SimResult, Summary)."""
    make, sdv2, cfg_cls, sim_cls, workloads, summ = sim_mod
    specs = workloads[wl](n=N_STREAMS, rate=1.0, seed=3)
    cfg = sdv2.sim_config() if name == "sdv2" else cfg_cls()
    res = sim_cls(cfg, specs, make(name)).run()
    return res, summ(res)


_TORCH = (make_policy, SDV2Policy, SimConfig, Simulator, WORKLOADS,
          summarize)
_JAX = (jmake_policy, JSDV2, JSimConfig, JSimulator, JWORKLOADS,
        jsummarize)


def _stream_view(s):
    return (s.sid, s.model, s.target_chunks, s.chunks_done, s.home,
            list(s.ready_times), list(s.deadlines), list(s.fidelity_log),
            list(s.qualities), list(s.stall_events), s.stall_time)


@pytest.mark.parametrize("wl", WORKLOAD_NAMES)
@pytest.mark.parametrize("name", POLICIES)
def test_simulator_matches_jax(name, wl):
    tres, tsum = _run(_TORCH, name, wl)
    jres, jsum = _run(_JAX, name, wl)
    assert dataclasses.asdict(tsum) == dataclasses.asdict(jsum)
    assert tsum.n_streams == N_STREAMS and tsum.n_chunks > 0
    for field in ("n_rehomings", "n_sp_events", "worker_tier_samples",
                  "fidelity_counts", "admission", "n_workers_final"):
        assert getattr(tres, field) == getattr(jres, field), field
    assert sorted(tres.streams) == sorted(jres.streams)
    for sid in tres.streams:
        assert _stream_view(tres.streams[sid]) == \
            _stream_view(jres.streams[sid]), sid
    assert [dataclasses.astuple(t) for t in tres.engine.log] == \
        [dataclasses.astuple(t) for t in jres.engine.log]


@pytest.mark.parametrize("argv", [
    "--sim --workload steady --policy slackserve --streams 50",
    "--sim --workload burst --policy sdv2 --streams 40 --seed 2",
    "--sim --workload mixed_models --policy ts-chunk --streams 30",
    "--sim --workload steady --policy ts --streams 40 --front-door "
    "--model self-forcing --device-count 0 --workers-per-node 4",
])
def test_launcher_sim_prints_the_reference_summary(argv, monkeypatch,
                                                   capsys):
    out = {}
    for name, mod in (("torch", tserve), ("jax", jserve)):
        monkeypatch.setattr(sys, "argv", ["serve"] + argv.split())
        mod.main()
        out[name] = capsys.readouterr().out
    assert out["torch"] == out["jax"]
    assert "QoE=" in out["torch"]


def test_launcher_rejects_what_the_reference_rejects(monkeypatch):
    for argv in ("--sim --step-cache", "--sim --calibrate",
                 "--sim --models ardit-self-forcing", "--sim --lanes 2",
                 "--real --device-count 2", "--sim --real"):
        monkeypatch.setattr(sys, "argv", ["serve"] + argv.split())
        with pytest.raises(SystemExit):
            tserve.main()


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _measured(profile, factor, n=6):
    return {p.fidelity.key: factor * (1 + 0.1 * i) * p.latency
            for i, p in enumerate(profile.points[:n])}


@pytest.mark.parametrize("step_cache", [False, True])
def test_fit_primitives_match_jax(step_cache):
    tp = get_profile(step_cache=step_cache)
    jp = jget_profile(step_cache=step_cache)
    measured = _measured(tp, 1.7)
    assert measured == _measured(jp, 1.7)
    # cache-on keys beside their off siblings feed fit_cache_speedups
    keys = [p.fidelity.key for p in tp.points if p.fidelity.cache == "off"]
    for i, k in enumerate(keys[:4]):
        measured[k] = 0.5 + i
        measured[k + "_ca"] = 0.3 + 0.5 * i
        measured[k + "_cc"] = 0.45 + 0.9 * i
    measured["bogus"] = 1.0
    assert TC.fit_ratios(measured, tp) == JC.fit_ratios(measured, jp)
    assert TC.fit_cache_speedups(measured) == \
        JC.fit_cache_speedups(measured)
    for times in ({b: 0.5 * (1 + 0.15 * (b - 1)) for b in (1, 2, 3, 4)},
                  {2: 1.0}, {1: 1.0}, {1: 1.0, 4: 0.5}, {1: 0.2, 2: 0.24}):
        assert TC.fit_batch_alpha(times) == JC.fit_batch_alpha(times)
    assert (TC.QOE_ABS_TOL, TC.TTFC_REL_TOL) == \
        (JC.QOE_ABS_TOL, JC.TTFC_REL_TOL)


@pytest.mark.parametrize("real,sim", [((0.9, 2.0), (0.8, 3.0)),
                                      ((0.9, 2.0), (0.5, 2.0)),
                                      ((0.9, 1.0), (0.9, 3.0)),
                                      ((1.0, 0.0), (1.0, 1.0)),
                                      ((0.7, math.inf), (0.7, 1.0))])
def test_agreement_matches_jax(real, sim):
    @dataclasses.dataclass
    class S:
        qoe: float
        ttfc: float
    assert TC.agreement(S(*real), S(*sim)) == JC.agreement(S(*real),
                                                            S(*sim))


def _session(**cfg_kw):
    """A session over the port's batched executor at the reduced config
    with 2 layers, on the CPU (the reference tests' ``make_session``)."""
    cfg = _cfgs(n_layers=2, ardit_window_chunks=2)[1]
    ex = TB.BatchedChunkExecutor(cfg=cfg, max_streams=4, device="cpu")
    return TS.StreamingSession(TS.SessionConfig(verbose=False, device="cpu",
                                                **cfg_kw), executor=ex)


def test_fit_session_and_calibrated_replay_agree():
    """The reference's check on the port: a real session's fit, replayed
    through the calibrated simulator, agrees with the run within the
    pinned tolerances."""
    specs = TS.cap_specs(steady(n=3, rate=2.0, seed=7), 3)
    sess = _session(executor="batched")
    for spec in specs:
        sess.submit(spec)
    real = summarize(sess.run())
    report = TC.fit_session(sess)
    assert "S4_r0.0_W7_bf16" in report.ratios
    assert report.scale == pytest.approx(report.ratios["S4_r0.0_W7_bf16"])
    assert report.chunk_seconds == pytest.approx(sess.chunk_seconds)
    cfg = report.sim_config(n_workers=1, workers_per_node=1)
    assert cfg.profile is not None and cfg.chunk_seconds > 0.0
    sim = summarize(Simulator(cfg, specs, make_policy(
        "slackserve", model=report.model,
        profile=report.profile())).run())
    agr = TC.agreement(real, sim)
    assert agr["ok"], agr
    assert agr["qoe_tol"] == TC.QOE_ABS_TOL
    assert agr["ttfc_rel_tol"] == TC.TTFC_REL_TOL
    # the batch slope passes through to the replay's config
    rep2 = TC.fit_session(sess, batch_step_times={1: 0.2, 2: 0.24})
    assert rep2.batch_alpha == pytest.approx(0.2)
    assert rep2.sim_config().batch_alpha == pytest.approx(0.2)


def test_sim_vs_real_summary_parity():
    """The same StreamSpec list through the simulator and the port's
    real session yields Summary objects with identically defined
    fields, and the stall accounting holds on the real side."""
    specs = TS.cap_specs(steady(n=3, rate=50.0, seed=1), 2)
    sess = _session(arrival_scale=0.1)
    for s in specs:
        sess.submit(s)
    res_real = sess.run()
    s_real = summarize(res_real)
    res_sim = Simulator(SimConfig(), specs, make_policy("slackserve")).run()
    s_sim = summarize(res_sim)
    for s in (s_real, s_sim):
        assert isinstance(s, Summary)
        assert 0.0 <= s.qoe <= 1.0
        assert s.ttfc > 0.0 and math.isfinite(s.ttfc)
        assert s.n_streams == len(specs)
        assert s.n_chunks == sum(sp.chunks for sp in specs)
        assert s.quality > 0.0
        assert s.stalls_per_stream >= 0.0 and s.avg_stall_ms >= 0.0
    for rec in res_real.streams.values():
        late = sum(1 for r, d in zip(rec.ready_times, rec.deadlines)
                   if r > d)
        assert len(rec.stall_events) == late
        assert sum(rec.stall_events) == pytest.approx(rec.stall_time)
    assert set(stall_histogram(res_real)) == set(stall_histogram(res_sim))
    assert set(transfer_stats(res_real)) == set(transfer_stats(res_sim))


def test_sim_front_door_matches_jax():
    specs = WORKLOADS["burst"](n=120, rate=4.0, seed=5)
    jspecs = JWORKLOADS["burst"](n=120, rate=4.0, seed=5)
    tcfg = dataclasses.replace(SimConfig(), front_door=FrontDoorConfig())
    from repro.sched_sim.frontdoor import FrontDoorConfig as JFD
    jcfg = dataclasses.replace(JSimConfig(), front_door=JFD())
    tres = Simulator(tcfg, specs, make_policy("slackserve")).run()
    jres = JSimulator(jcfg, jspecs, jmake_policy("slackserve")).run()
    assert tres.admission == jres.admission and tres.admission
    assert tres.n_workers_final == jres.n_workers_final
    assert dataclasses.asdict(summarize(tres)) == \
        dataclasses.asdict(jsummarize(jres))
