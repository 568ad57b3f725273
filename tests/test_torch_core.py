"""The port's copies of the control plane (``core/``, ``profiler/``,
``sched_sim/workloads.py``) held to the reference by property: the same
hypothesis draws go into both packages and their results, and the state
they leave behind, must be equal (exactly: both are pure Python over the
same floats).  The behaviours are those ``tests/test_core.py``,
``tests/test_state_plane.py`` and ``tests/test_properties.py`` test
on the reference: the workload generators spec for spec, BMPR and the
profiles, service credit and tiers, the three-tier queues and eviction,
re-homing, elastic SP and the control tick on drawn cluster states, the
page pool's and the transfer engine's accounting op by op.

The port's own torch modules are held to the reference's properties at
the reference's tolerances: the ring cache's window and sink (exact, and
equal to JAX's), the online-softmax merge over drawn segments (1e-5),
``quantize_fp8_ref``'s error (amax / 8) and the SSD's chunked scan
against its recurrence (5e-4).

Draws are derandomized, so every run runs the same examples.
"""
import dataclasses
import enum
import functools
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch
from hypothesis import given, settings, strategies as st

from repro.core import bmpr as J_bmpr
from repro.core import control_plane as J_cp
from repro.core import elastic_sp as J_sp
from repro.core import fidelity as J_fid
from repro.core import queues as J_q
from repro.core import rehoming as J_rh
from repro.core import slack as J_slack
from repro.core import state_plane as J_state
from repro.core import types as J_types
from repro.models import kvcache as J_kv
from repro.profiler import profiles as J_prof
from repro.sched_sim import workloads as J_wl
from repro_torch.core import bmpr as T_bmpr
from repro_torch.core import control_plane as T_cp
from repro_torch.core import elastic_sp as T_sp
from repro_torch.core import fidelity as T_fid
from repro_torch.core import queues as T_q
from repro_torch.core import rehoming as T_rh
from repro_torch.core import slack as T_slack
from repro_torch.core import state_plane as T_state
from repro_torch.core import types as T_types
from repro_torch.kernels.fp8_matmul.ref import quantize_fp8_ref
from repro_torch.kernels.ssd_scan.ref import ssd_decode_ref, ssd_ref
from repro_torch.models import attention as T_attn
from repro_torch.models import kvcache as T_kv
from repro_torch.profiler import profiles as T_prof
from repro_torch.sched_sim import workloads as T_wl

torch.set_num_threads(2)

SETTINGS = settings(max_examples=25, deadline=None, derandomize=True,
                    database=None)
# the pure-Python decisions are cheap: more drawn states; the ring cache
# dispatches JAX ops at a new shape per example
DECISIONS = settings(SETTINGS, max_examples=150)
RING = settings(SETTINGS, max_examples=12)

REF = types.SimpleNamespace(
    bmpr=J_bmpr, cp=J_cp, sp=J_sp, fid=J_fid, q=J_q, rh=J_rh, slack=J_slack,
    state=J_state, types=J_types, prof=J_prof, wl=J_wl)
PORT = types.SimpleNamespace(
    bmpr=T_bmpr, cp=T_cp, sp=T_sp, fid=T_fid, q=T_q, rh=T_rh, slack=T_slack,
    state=T_state, types=T_types, prof=T_prof, wl=T_wl)


def plain(x):
    """A value of either package as builtins: dataclasses and named
    tuples by class name and fields, enums by name and value, functions
    and classes by qualified name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple(plain(v) for v in x)
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return frozenset(plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if callable(x):
        return ("callable", x.__qualname__)
    return x


def outcome(fn, *args, **kwargs):
    """``plain`` of what ``fn`` returns, or the type of what it raises."""
    try:
        return plain(fn(*args, **kwargs))
    except Exception as e:      # the two packages must raise alike
        return ("raises", type(e).__name__)


def same(fn):
    """``fn(pkg)`` on the reference and on the port: equal outcomes."""
    want, got = outcome(fn, REF), outcome(fn, PORT)
    assert got == want
    return got


# the port's copies of the reference's pure-Python modules
COPIES = ("core.bmpr", "core.control_plane", "core.elastic_sp",
          "core.fidelity", "core.queues", "core.rehoming", "core.slack",
          "core.state_plane", "core.types", "profiler.profiles",
          "sched_sim.calibration", "sched_sim.cost_model",
          "sched_sim.frontdoor", "sched_sim.metrics", "sched_sim.policies",
          "sched_sim.simulator", "sched_sim.workloads")


@pytest.mark.parametrize("module", COPIES)
def test_copied_module_constants_match(module):
    """Every upper-case module constant (thresholds, caps, profile
    coefficients) equal in the copy: a constant that moves only at a
    boundary no drawn example reaches is still caught here."""
    def constants(pkg):
        m = importlib.import_module(f"{pkg}.{module}")
        return {k: plain(v) for k, v in vars(m).items()
                if k.isupper() and not callable(v)
                and not isinstance(v, types.ModuleType)}
    assert constants("repro_torch") == constants("repro")


# ---------------------------------------------------------------------------
# workload generators, spec for spec
# ---------------------------------------------------------------------------

def test_workload_registry_matches():
    assert list(T_wl.WORKLOADS) == list(J_wl.WORKLOADS)
    assert T_wl.N_PROMPTS == J_wl.N_PROMPTS


@pytest.mark.parametrize("name", sorted(J_wl.WORKLOADS))
@SETTINGS
@given(n=st.integers(0, 150), rate=st.floats(0.05, 10.0),
       seed=st.integers(0, 99))
def test_workload_generators_match(name, n, rate, seed):
    same(lambda P: P.wl.WORKLOADS[name](n=n, rate=rate, seed=seed))


@SETTINGS
@given(n=st.integers(1, 200), seed=st.integers(0, 99),
       period=st.floats(1.0, 500.0), trough=st.floats(0.0, 1.0),
       spike_frac=st.floats(0.0, 1.0), width=st.floats(0.0, 5.0),
       models=st.lists(st.sampled_from(["causal-forcing", "self-forcing",
                                        "mamba2-780m"]), max_size=3),
       weighted=st.booleans())
def test_workload_options_match(n, seed, period, trough, spike_frac, width,
                                models, weighted):
    same(lambda P: P.wl.diurnal(n=n, rate=2.0, seed=seed, period=period,
                                trough=trough))
    same(lambda P: P.wl.flash_crowd(n=n, rate=2.0, seed=seed,
                                    spike_frac=spike_frac,
                                    spike_width=width))
    weights = tuple(1.0 + i for i in range(len(models))) if weighted \
        else None
    specs = same(lambda P: P.wl.mixed_models(
        n=n, seed=seed, models=tuple(models), weights=weights))
    same(lambda P: [(s.chunks, s.duration) for s in
                    P.wl.steady(n=n, seed=seed)])
    assert specs[0] == "raises" or len(specs) == n


# ---------------------------------------------------------------------------
# BMPR and the profiles
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bmpr(pkg, model, step_cache):
    P = REF if pkg == "ref" else PORT
    return P.bmpr.BMPR(P.prof.get_profile(model, step_cache=step_cache))


def test_fidelity_space_and_profiles_match():
    for sc in (False, True):
        same(lambda P: P.fid.candidate_space(step_cache=sc))
        for model in ("causal-forcing", "self-forcing"):
            same(lambda P: P.prof.get_profile(model, step_cache=sc))
            same(lambda P: P.bmpr.pareto_frontier(
                P.prof.get_profile(model, step_cache=sc)))


@pytest.mark.parametrize("model", ["causal-forcing", "self-forcing"])
@pytest.mark.parametrize("step_cache", [False, True])
@SETTINGS
@given(budgets=st.lists(st.floats(-1.0, 5.0), min_size=1, max_size=6))
def test_bmpr_select_matches(model, step_cache, budgets):
    """The same fidelity key, mode, latency and quality for any budget
    (odd ones included), per budget and in bulk; the fixed-level and
    static policies too."""
    pkgs = {"ref": REF, "port": PORT}
    out = {}
    for name, P in pkgs.items():
        b = _bmpr(name, model, step_cache)
        prof = b.profile
        out[name] = plain((
            [(d.fidelity.key, d.mode, d.latency, d.quality)
             for d in map(b.select, budgets)],
            b.select_bulk(np.asarray(budgets)),
            [b.eligible_points()[i].fidelity.key
             for i in b.select_bulk(np.asarray(budgets))],
            [P.bmpr.FixedLevelSwitcher(prof).select(x) for x in budgets],
            [P.bmpr.StaticFidelity().select(x) for x in budgets]))
    assert out["port"] == out["ref"]


@SETTINGS
@given(steps=st.sampled_from((2, 3, 4)),
       sparsity=st.sampled_from((0.0, 0.6, 0.9)),
       window=st.sampled_from((1, 3, 7)), quant=st.sampled_from(("bf16",
                                                                 "fp8")),
       sp=st.integers(1, 4), ratio=st.floats(0.1, 10.0),
       scale=st.floats(0.1, 10.0), speedup=st.floats(0.1, 1.0),
       model=st.sampled_from(("causal-forcing", "self-forcing")))
def test_profile_latency_and_calibration_match(steps, sparsity, window,
                                               quant, sp, ratio, scale,
                                               speedup, model):
    def run(P):
        cfg = P.fid.FidelityConfig(steps, sparsity, window, quant)
        cached = cfg._replace(cache="aggressive")
        base = P.prof.get_profile(model, step_cache=True)
        cal = P.prof.calibrate_profile(
            base, {cfg.key: ratio}, scale=scale,
            cache_speedups={"conservative": speedup})
        return (P.prof.chunk_latency(cfg, sp_degree=sp, model=model),
                P.prof.chunk_quality(cached, model=model),
                P.prof.step_cache_latency_factor("aggressive", steps),
                cal.latency(cached, sp), cal.points)
    same(run)


# ---------------------------------------------------------------------------
# service credit and tiers
# ---------------------------------------------------------------------------

@DECISIONS
@given(ddl=st.floats(-10, 100), now=st.floats(0, 100),
       t_next=st.floats(0.0, 5), rem=st.floats(0, 5),
       running=st.booleans(), alpha=st.floats(0.5, 4.0))
def test_service_credit_and_tiers_match(ddl, now, t_next, rem, running,
                                        alpha):
    def run(P):
        s = P.types.Stream(sid=0, arrival=0.0, target_chunks=1,
                           chunk_seconds=0.75, home=0, ttfc_slack=1.0,
                           next_deadline=ddl)
        s.t_next = t_next
        s.remaining = rem
        s.running_on = (0,) if running else None
        c = P.slack.service_credit(s, now)
        out = (c, P.slack.classify(c, t_next),
               P.slack.classify(c, t_next, alpha))
        P.slack.update_stream_credit(s, now, alpha)
        return out + (s.credit, s.tier, s.playout_slack(now))
    same(run)


# ---------------------------------------------------------------------------
# drawn cluster states: queues, re-homing, elastic SP, the control tick
# ---------------------------------------------------------------------------

@st.composite
def clusters(draw):
    n_workers = draw(st.integers(1, 6))
    per_node = draw(st.integers(1, 4))
    streams = []
    for _ in range(draw(st.integers(0, 12))):
        # near deadlines crowd onto worker 0 and far ones spread: senders
        # with several urgent streams beside relaxed receivers
        kind = draw(st.sampled_from(("near", "far", "any")))
        streams.append(dict(
            home=draw(st.sampled_from((0, 0) + tuple(range(n_workers)))
                      if kind == "near" else st.integers(0, n_workers - 1)),
            deadline=draw({"near": st.floats(-3.0, 1.0),
                           "far": st.floats(15.0, 60.0),
                           "any": st.floats(-3.0, 40.0)}[kind]),
            t_next=draw(st.floats(0.0, 3.0)),
            running=draw(st.booleans()),
            remaining=draw(st.floats(0.0, 2.0)),
            paused=draw(st.sampled_from((-1.0, 0.5, 9.0))),
            cooldown=draw(st.sampled_from((-1e9, 5.0, 100.0))),
            done=draw(st.integers(0, 7)) == 0,
            chunks_done=draw(st.integers(0, 3)),
            target=draw(st.integers(1, 4))))
    donating = {}
    for sid, s in enumerate(streams):
        free = [w for w in range(n_workers)
                if w != s["home"] and w not in donating]
        if free and draw(st.integers(0, 3)) == 0:
            donating[draw(st.sampled_from(free))] = sid
    retired = [draw(st.integers(0, 5)) == 0 for _ in range(n_workers)]
    return dict(n_workers=n_workers, per_node=per_node, streams=streams,
                donating=donating, retired=retired,
                weighted=draw(st.booleans()))


def _weight(sid):
    """A co-serving placement weight per stream (one function for both
    packages, so the views compare equal)."""
    return 1.0 + 0.5 * (sid % 3)


def build(P, c):
    """The drawn cluster as package ``P``'s ``ClusterView``."""
    workers = [P.types.Worker(w, node=w // c["per_node"],
                              retired=c["retired"][w])
               for w in range(c["n_workers"])]
    streams = {}
    for sid, d in enumerate(c["streams"]):
        s = P.types.Stream(
            sid=sid, arrival=0.0, target_chunks=d["target"],
            chunk_seconds=0.75, home=d["home"], ttfc_slack=3.0,
            next_deadline=d["deadline"], chunks_done=d["chunks_done"],
            paused_until=d["paused"], cooldown_until=d["cooldown"],
            done=d["done"])
        s.t_next = d["t_next"]
        s.remaining = d["remaining"]
        home = workers[d["home"]]
        if d["running"]:
            s.running_on = (d["home"],)
            if home.running is None:
                home.running = sid
        streams[sid] = s
        home.queue.append(sid)
    for w, sid in c["donating"].items():
        workers[w].donated_to = sid
        streams[sid].sp_donor = w
    return P.types.ClusterView(streams, workers, c["per_node"],
                               _weight if c["weighted"] else None)


def credited(P, c, now):
    view = build(P, c)
    for s in view.streams.values():
        P.slack.update_stream_credit(s, now)
    return view


@DECISIONS
@given(c=clusters(), now=st.floats(0.0, 20.0),
       max_batch=st.one_of(st.none(), st.integers(1, 4)),
       protect=st.lists(st.integers(0, 9), max_size=3))
def test_three_tier_queues_match(c, now, max_batch, protect):
    def run(P):
        view = credited(P, c, now)
        P.q.order_all(view)
        sids = list(view.streams)
        return (view,
                [P.q.next_dispatch_set(w, view.streams, now, max_batch)
                 for w in view.workers],
                [P.q.next_dispatch(w, view.streams, now)
                 for w in view.workers],
                P.q.pick_eviction(sids, view.streams, protect),
                P.q.pick_eviction(sids, view.streams,
                                  protect[0] if protect else None),
                P.q.pick_page_eviction(sids, view.streams, protect,
                                       lambda sid: sid % 2 == 0),
                P.q.tier_counts(view), P.q.worker_class_triple(view),
                P.q.min_credits(view))
    same(run)


@DECISIONS
@given(c=clusters(), now=st.floats(0.0, 20.0))
def test_rehoming_matches(c, now):
    def run(P):
        view = credited(P, c, now)
        P.q.order_all(view)
        plan = P.rh.plan_rehoming(view, now)
        for m in plan:
            P.rh.apply_migration(view, m)
        return plan, view
    same(run)


@DECISIONS
@given(c=clusters(), now=st.floats(0.0, 20.0),
       exclude=st.lists(st.integers(0, 9), max_size=2),
       hoisted=st.booleans())
def test_elastic_sp_matches(c, now, exclude, hoisted):
    def run(P):
        view = credited(P, c, now)
        P.q.order_all(view)
        decs = P.sp.plan_elastic_sp(
            view, now, exclude=set(exclude),
            donor_credits=P.q.min_credits(view) if hoisted else None)
        for d in decs:
            (P.sp.apply_expand if d.kind == "expand"
             else P.sp.apply_release)(view, d)
        return decs, view
    same(run)


@DECISIONS
@given(c=clusters(), now=st.floats(0.0, 20.0), vectorized=st.booleans(),
       use_fidelity=st.booleans(), rehoming=st.booleans(),
       elastic=st.booleans())
def test_control_tick_matches(c, now, vectorized, use_fidelity, rehoming,
                              elastic):
    def run(P):
        view = build(P, c)
        cp = P.cp.ControlPlane(P.cp.ControlConfig(
            use_fidelity=use_fidelity, use_rehoming=rehoming,
            use_elastic_sp=elastic, vectorized=vectorized))
        d = cp.tick(view, now)
        return (d.migrations, d.sp_decisions, d.scale_out, d.scale_in,
                cp.n_rehomings, cp.n_sp_events, view, cp.choose_home(view)
                if view.workers else None, cp.initial_slack(0.5))
    same(run)


# ---------------------------------------------------------------------------
# the state plane, op by op
# ---------------------------------------------------------------------------

@DECISIONS
@given(n_pages=st.integers(0, 16),
       ops=st.lists(st.tuples(
           st.sampled_from(("alloc", "alloc", "release", "release_pages",
                            "can_alloc", "pages_of", "resident")),
           st.integers(0, 2), st.integers(0, 4)), min_size=8, max_size=40))
def test_paged_pool_accounting_matches(n_pages, ops):
    def run(P):
        pool = P.state.PagedKVPool(n_pages)
        log = []
        for op, sid, n in ops:
            if op in ("alloc", "release_pages"):
                log.append(outcome(getattr(pool, op), sid, n))
            elif op == "can_alloc":
                log.append(pool.can_alloc(n))
            else:
                log.append(getattr(pool, op)(sid))
            pool.check()
            log.append((pool.free, pool.used, dict(pool.tables),
                        pool.resident_sids()))
        return log
    same(run)


@DECISIONS
@given(protocol=st.sampled_from(("sync", "async-nostream", "async-stream")),
       n_layers=st.integers(1, 40), calibrate=st.booleans(),
       ops=st.lists(st.tuples(st.booleans(), st.floats(0.0, 50.0),
                              st.integers(0, 10**10), st.booleans(),
                              st.floats(1e-6, 2.0)), max_size=12))
def test_transfer_engine_matches(protocol, n_layers, calibrate, ops):
    def run(P):
        eng = P.state.AsyncTransferEngine(protocol=protocol,
                                          n_layers=n_layers,
                                          calibrate=calibrate)
        log = []
        for measure, now, n_bytes, cross, seconds in ops:
            if measure:
                m = eng.record_measured(n_bytes, seconds, cross_node=cross,
                                        kind="migration")
                log.append((m, m.bytes_per_s))
            else:
                t = eng.transfer(now, n_bytes, cross_node=cross)
                log.append((t, t.total, t.residual_wait))
            log.append((eng.bw_intra, eng.bw_inter))
        return (log, eng.log, eng.measured, eng.measured_stats(),
                eng.blocks_dispatcher())
    same(run)


# ---------------------------------------------------------------------------
# the port's torch modules against the reference's properties
# ---------------------------------------------------------------------------

@RING
@given(s=st.integers(1, 60), sink=st.integers(0, 8),
       window=st.integers(2, 20))
def test_ring_cache_holds_exactly_window_and_sink(s, sink, window):
    cap = T_kv.capacity(s, window, sink)
    assert cap == J_kv.capacity(s, window, sink)
    assert cap <= s and cap <= sink + window
    pos = torch.arange(s, dtype=torch.int32)
    dest = T_kv.ring_dest(pos, cap, sink).numpy()
    np.testing.assert_array_equal(
        dest, np.asarray(J_kv.ring_dest(jnp.arange(s, dtype=jnp.int32), cap,
                                        sink)))
    slots = -np.ones(cap, np.int64)
    for p, d in enumerate(dest):
        assert 0 <= d < cap
        slots[d] = p
    expected = set(range(min(sink, s)))
    expected |= set(range(max(min(sink, s), s - (cap - sink)), s))
    assert set(slots[slots >= 0].tolist()) == expected
    k = np.arange(1, s + 1, dtype=np.float32).reshape(1, s, 1, 1)
    placed = T_kv.place_prefill(torch.from_numpy(k), cap, sink,
                                window).numpy()
    np.testing.assert_array_equal(placed, np.asarray(
        J_kv.place_prefill(jnp.asarray(k), cap, sink, window)))
    for slot in range(cap):
        if slots[slot] >= 0:
            assert placed[0, slot, 0, 0] == slots[slot] + 1


@SETTINGS
@given(seed=st.integers(0, 99), n_seg=st.integers(2, 5))
def test_online_softmax_merge_is_associative(seed, n_seg):
    from repro.models import attention as J_attn
    rng = np.random.default_rng(seed)
    B, H, G, Q, D, S = 1, 1, 2, 4, 8, 8 * n_seg
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((B, Q, H, G, D), (B, S, H, D), (B, S, H, D)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    full = T_attn._finalize(T_attn._merge(
        T_attn._init_acc(B, H, G, Q, D),
        T_attn._segment_attn(tq, tk, tv, None, 1.0)), torch.float32)
    acc = T_attn._init_acc(B, H, G, Q, D)
    for i in range(n_seg):
        seg = slice(i * 8, (i + 1) * 8)
        acc = T_attn._merge(acc, T_attn._segment_attn(tq, tk[:, seg],
                                                      tv[:, seg], None, 1.0))
    np.testing.assert_allclose(T_attn._finalize(acc, torch.float32).numpy(),
                               full.numpy(), rtol=1e-5, atol=1e-5)
    want = J_attn._finalize(J_attn._merge(
        J_attn._init_acc(B, H, G, Q, D),
        J_attn._segment_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None, 1.0)), jnp.float32)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@SETTINGS
@given(m=st.integers(1, 16), k=st.integers(1, 64), seed=st.integers(0, 99),
       scale=st.floats(1e-3, 1e3))
def test_fp8_quant_relative_error(m, k, seed, scale):
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(m, k)).astype(np.float32)) * scale
    q, s = quantize_fp8_ref(x, axis=1)
    err = (q.float() * s - x).abs()
    amax = x.abs().amax(dim=1, keepdim=True)
    # e4m3 has >= 2 mantissa bits near amax: error <= amax / 8 everywhere
    assert bool((err <= amax / 8.0 + 1e-9).all())


@SETTINGS
@given(s=st.integers(3, 40), h=st.integers(1, 3), p=st.integers(1, 8),
       n=st.integers(1, 8), chunk=st.integers(2, 16), seed=st.integers(0, 99))
def test_ssd_chunked_equals_sequential(s, h, p, n, chunk, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    x = t(1, s, h, p)
    dt = torch.nn.functional.softplus(t(1, s, h))
    A = -torch.exp(t(h))
    Bm, Cm = t(1, s, 1, n), t(1, s, 1, n)
    y_c, f_c = ssd_ref(x, dt, A, Bm, Cm, chunk=chunk)
    state = torch.zeros((1, h, p, n))
    ys = []
    for i in range(s):
        y, state = ssd_decode_ref(x[:, i], dt[:, i], A, Bm[:, i], Cm[:, i],
                                  state)
        ys.append(y)
    np.testing.assert_allclose(y_c.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(f_c.numpy(), state.numpy(), rtol=5e-4,
                               atol=5e-4)
