"""The serving path's tracer (``repro_torch/profiler/trace.py``) on the
reduced AR-DiT config the session tests use (2 layers, a window of 2
chunks: ``test_torch_layers._cfgs(n_layers=2, ardit_window_chunks=2)``'s
port config, built here without JAX) under ``StaticFidelity``, on the
CPU.

Off, it creates nothing and the chunks are the ones it serves when on,
bit for bit.  On, each ``executor.run_step`` span holds what the
benchmark's own step wrapper records for the same launch; host spans
nest; every chunk record orders runnable <= begin <= ready with its
active seconds inside; the round counters add up, and a round that
mixes two KV dtypes counts one split launch.  The ``cuda`` case serves
on the card and holds the device spans to the host clock.
"""
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.bmpr import StaticFidelity
from repro_torch.core.fidelity import FidelityConfig
from repro_torch.profiler import trace
from repro_torch.serve import batcher as TB
from repro_torch.serve import session as TS

ROOT = Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(get_config("ardit-self-forcing").reduced(),
                          n_layers=2, ardit_window_chunks=2)
FID = (2, 0.0, 2, "bf16")
EPS = 1e-9          # rounding of host times taken on two clock origins


@pytest.fixture(autouse=True)
def tracing_off():
    """Every case starts and ends with tracing off."""
    trace.stop()
    yield
    trace.stop()


def _session(n, chunks, max_batch, pool, device="cpu", fid=FID):
    ts = TS.StreamingSession(
        TS.SessionConfig(verbose=False, max_batch=max_batch, device=device),
        executor=TB.BatchedChunkExecutor(cfg=CFG, seed=0, max_streams=pool,
                                         device=device),
        fidelity_policy=StaticFidelity(FidelityConfig(*fid)))
    for spec in TS.uniform_specs(n, chunks):
        ts.submit(spec)
    return ts


def _served(ts, n):
    return {sid: ([c.cpu() for c in ts.handles[sid].chunks],
                  ts.handles[sid].fidelity_log) for sid in range(n)}


def _traced(n, chunks, max_batch, pool, device="cpu"):
    ts = _session(n, chunks, max_batch, pool, device)
    trace.start()
    ts.run()
    return ts, trace.stop()


def _boom(*args, **kwargs):
    raise AssertionError("the tracer built something while off")


def test_off_creates_nothing_and_serves_what_on_serves(monkeypatch):
    with monkeypatch.context() as m:
        for name in ("Record", "Span", "_HostSpan", "_DeviceSpan",
                     "_HostTimedDeviceSpan"):
            m.setattr(trace, name, _boom)
        m.setattr(torch.cuda, "Event", _boom)
        off = _session(2, 2, 2, 3)
        off.run()
        assert trace.active() is None
    ts, rec = _traced(2, 2, 2, 3)
    assert rec.spans and rec.device_spans and rec.chunks
    want, got = _served(off, 2), _served(ts, 2)
    for sid in range(2):
        assert got[sid][1] == want[sid][1]
        assert len(got[sid][0]) == len(want[sid][0]) == 2
        for a, b in zip(got[sid][0], want[sid][0]):
            assert torch.equal(a, b)


def test_run_step_spans_equal_the_benchmark_step_records(monkeypatch):
    """The benchmark's window on the CPU, its step wrapper installed as
    it installs it: one ``executor.run_step`` span inside each of its
    step records, with the same rows, keys, chunk indices, phases and
    launch flag."""
    if str(ROOT) not in sys.path:
        monkeypatch.syspath_prepend(str(ROOT))
    from streambench.lib import serve, traffic
    # the window replaces the executor's draws for the process
    monkeypatch.setattr(TB, "cond_noise", TB.cond_noise)
    monkeypatch.setattr(TB, "chunk_noise", TB.chunk_noise)
    here = ROOT / "streambench" / "tests"
    cfg = json.loads((here / "ardit-tiny.json").read_text())
    mix = json.loads((here / "tiny-mix.json").read_text())
    rec = serve.run_window(
        cfg, traffic.arrivals(mix, 1.5), seed=2 ** 31 + 5,
        ramp_s=float(mix["ramp_s"]), seconds=1.5, trace=False, device="cpu",
        t_process=time.perf_counter(),
        session_hook=lambda session: trace.start())
    prog = trace.stop()
    spans = [s for s in prog.spans if s.name == "executor.run_step"]
    assert len(spans) == len(rec.steps) > 0
    assert any(s.attrs["launched"] for s in spans)
    for sp, st in zip(spans, rec.steps):
        assert st.start <= sp.start <= sp.end <= st.end
        assert sp.attrs["keys"] == st.keys
        assert sp.attrs["chunk_idx"] == st.chunk_idx
        assert sp.attrs["denoise"] == st.denoise
        assert sp.attrs["launched"] == st.launched
        assert sp.attrs["rows"] == len(st.keys)
    # the readings the benchmark takes from such a record
    from streambench import program_trace as P
    assert 0.0 < P.segment_share(prog) < 100.0
    assert 0.0 <= P.split_launch_share(prog) < 100.0
    assert 0.0 <= P.queue_wait_share(prog) < 100.0


SESSIONS = {
    "fused": (2, 2, 2, 3),          # everyone resident, one batch a round
    "oversubscribed": (3, 2, 2, 2),  # spill and restore inside rounds
}


@pytest.mark.parametrize("shape", sorted(SESSIONS))
def test_spans_nest_and_children_fit(shape):
    _, rec = _traced(*SESSIONS[shape])
    spans = rec.spans
    child_s = [0.0] * len(spans)
    for sp in spans:
        assert sp.start <= sp.end
        if sp.parent >= 0:
            p = spans[sp.parent]
            assert p.start <= sp.start and sp.end <= p.end, (p, sp)
            child_s[sp.parent] += sp.end - sp.start
    for sp, c in zip(spans, child_s):
        assert (sp.end - sp.start) - c >= -EPS, sp
    # on the CPU a device span is timed on the host, inside its parent
    for sp in rec.device_spans:
        p = spans[sp.parent]
        assert p.start <= sp.start <= sp.end <= p.end
    names = {sp.name for sp in spans}
    assert {"session.schedule", "session.round", "session.tick",
            "session.residency",
            "session.begin_chunk", "session.complete_chunk",
            "executor.run_step", "executor.boundary", "executor.staging",
            "model.launch", "executor.append", "executor.sync",
            "executor.complete"} <= names
    assert {"device.step", "device.attn.context", "device.attn.chunk"} == \
        {sp.name for sp in rec.device_spans}
    steps = [i for i, sp in enumerate(spans) if sp.name == "executor.run_step"]
    for sp in spans:
        if sp.name.startswith("executor.") or sp.name == "model.launch":
            if sp.name != "executor.run_step":
                assert sp.parent in steps
        if sp.name == "session.tick":
            assert spans[sp.parent].name == "session.schedule"
        if sp.name in ("session.schedule", "session.round"):
            assert sp.parent == -1


@pytest.mark.parametrize("shape", sorted(SESSIONS))
def test_chunk_records_order_their_times(shape):
    n, chunks = SESSIONS[shape][:2]
    ts, rec = _traced(*SESSIONS[shape])
    assert len(rec.chunks) == n * chunks
    for c in rec.chunks:
        assert c["runnable"] <= c["begin"] + EPS
        assert c["begin"] <= c["ready"]
        assert 0.0 < c["active_s"] <= c["ready"] - c["runnable"] + EPS
        assert c["fidelity"] == FidelityConfig(*FID).key
        assert c["tier"] in ("URGENT", "NORMAL", "RELAXED")
        assert c["budget"] >= 0.0
    steps = {i: sp for i, sp in enumerate(rec.spans)
             if sp.name == "executor.run_step"}
    launch_s = {sp.parent: sp.end - sp.start for sp in rec.spans
                if sp.name == "model.launch"}
    for sid in range(n):
        mine = [c for c in rec.chunks if c["sid"] == sid]
        s = ts.view.streams[sid]
        assert [c["ready"] - ts._t0 for c in mine] == pytest.approx(
            s.ready_times, abs=1e-9)
        # runnable: the stream's arrival, then its previous chunk's ready
        assert [c["runnable"] - ts._t0 for c in mine] == pytest.approx(
            [s.arrival] + s.ready_times[:-1], abs=1e-9)
        # active: at least the launches of the steps the chunk took part
        # in, at most those steps' spans
        for c in mine:
            took = [i for i, sp in steps.items() if sid in sp.attrs["sids"]
                    and c["begin"] <= sp.start and sp.end <= c["ready"]]
            assert sum(launch_s[i] for i in took) <= c["active_s"] + EPS
            assert c["active_s"] <= sum(steps[i].end - steps[i].start
                                        for i in took) + EPS


@pytest.mark.parametrize("shape", sorted(SESSIONS))
def test_round_counters_add_up(shape):
    _, rec = _traced(*SESSIONS[shape])
    c = rec.counters
    steps = [sp for sp in rec.spans if sp.name == "executor.run_step"]
    rounds = [sp for sp in rec.spans if sp.name == "session.round"]
    assert c["rows"] == sum(sp.attrs["rows"] for sp in steps
                            if sp.attrs["launched"])
    assert c["launches"] == sum(sp.attrs["launched"] for sp in steps)
    assert c["launches"] - c["split_launches"] == \
        sum(sp.attrs["launches"] > 0 for sp in rounds)
    assert c["rounds"] == len(rounds)
    assert c["runnable"] == sum(sum(sp.attrs["runnable"]) for sp in rounds)
    if shape == "oversubscribed":
        res = [sp for sp in rec.spans if sp.name == "session.residency"]
        assert sum(sp.attrs["restores"] for sp in res) > 0
        assert c["residency_refused"] == sum(sp.attrs["refused"]
                                             for sp in res)


def test_a_two_dtype_round_counts_one_split_launch():
    """One bf16 row and one fp8 row made runnable together: the round
    launches twice, once beyond its first; each launch's layers run their
    in-chunk segments on the plain path (CPU tensors)."""
    ts = _session(2, 1, 4, 3)
    now = ts._now()
    ts._drain_events(now)
    ts.control.tick(ts.view, now)
    ex = ts.executor
    ex.begin_chunk(0, FidelityConfig(2, 0.0, 2, "bf16"), now)
    ex.begin_chunk(1, FidelityConfig(2, 0.0, 2, "fp8"), now)
    trace.start()
    ran, _ = ts._dispatch_round(now)
    rec = trace.stop()
    assert ran
    assert dict(rec.counters) == {
        **dict(rounds=1, launches=2, split_launches=1, rows=2, runnable=2,
               residency_refused=0),
        "flash_mha.plain_segments": 2 * CFG.n_layers}
    steps = [sp.attrs for sp in rec.spans if sp.name == "executor.run_step"]
    assert [s["keys"] for s in steps] == [["S2_r0.0_W2_bf16"],
                                          ["S2_r0.0_W2_fp8"]]
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from streambench import program_trace as P
    assert P.split_launch_share(rec) == 50.0


def _span(name, start, end, parent=-1):
    return trace.Span(name, start, end, parent=parent)


# (spans as (name, start, end, parent), time, innermost open span's name)
NESTED = [("round", 0.0, 10.0, -1), ("step", 1.0, 4.0, 0),
          ("sync", 2.0, 3.0, 1), ("step", 5.0, 6.0, 0),
          ("tick", 11.0, 12.0, -1)]
AT = [
    (2.5, "sync"),
    (3.5, "step"),       # a closed child inside an open parent
    (4.5, "round"),      # closed children inside an open grandparent
    (5.5, "step"),
    (10.5, None),        # between top-level spans
    (11.5, "tick"),
    (-1.0, None),        # before every span
]


@pytest.mark.parametrize("t,want", AT)
def test_innermost_open_span(t, want):
    got = trace.labeller([_span(*s) for s in NESTED])(t)
    assert (got.name if got is not None else None) == want


# anchors (device seconds since the first, host time): the card's timer
# runs 20 ppm fast against the host's clock
ANCHORS = [(0.0, 100.0), (1.0, 100.99998), (3.0, 102.99994)]
PLACED = [(0.5, 100.49999), (2.0, 101.99996), (4.0, 103.99992),
          (-0.5, 99.50001)]


@pytest.mark.parametrize("g,want", PLACED)
def test_device_times_placed_between_anchors(g, want):
    assert trace._placer(ANCHORS)(g) == pytest.approx(want, abs=1e-9)
    assert trace._placer(ANCHORS[:1])(g) == pytest.approx(100.0 + g)


@pytest.mark.cuda
def test_device_spans_on_the_host_clock():
    """On the card: device spans resolve on the host clock, each kernel 1
    and in-chunk span inside its launch's ``device.step``, every device
    span after the host began its enqueue; tracing changes no bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    off = _session(2, 2, 2, 3, device="cuda")
    off.run()
    ts, rec = _traced(2, 2, 2, 3, device="cuda")
    for sid in range(2):
        for a, b in zip(_served(ts, 2)[sid][0], _served(off, 2)[sid][0]):
            assert torch.equal(a, b)
    # anchors at the start, at each completion's wait, at the stop
    clock = rec.clock[torch.cuda.current_device()]
    assert rec.device_spans
    assert len(clock) >= 2 + sum(sp.name == "executor.sync"
                                 for sp in rec.spans)
    assert all(w >= 0.0 for _, _, w in clock)
    steps = sorted((sp for sp in rec.device_spans if sp.name == "device.step"),
                   key=lambda sp: sp.start)
    for sp in rec.device_spans:
        assert math.isfinite(sp.start) and sp.start <= sp.end
        assert rec.t_start <= sp.start and sp.end <= rec.t_end + 1.0
        assert sp.start >= rec.spans[sp.parent].start - 1e-4
        if sp.name != "device.step":
            assert any(st.start <= sp.start and sp.end <= st.end
                       for st in steps), sp
    n_layers = CFG.n_layers
    for name in ("device.attn.context", "device.attn.chunk"):
        assert sum(sp.name == name for sp in rec.device_spans) == \
            n_layers * len(steps)
