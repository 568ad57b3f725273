"""Multi-lane serving in the port, on the CPU: the reference's
``tests/test_lanes.py`` and the same-device tests of
``tests/test_device_lanes.py``, in torch on the reduced config (2
layers), plus one JAX-vs-torch parity test of ``denoise_step_paged_sp``.

Bit-exact where the reference asserts bit exactness: the SP2 head-split
step equals the SP1 step, batch-axis SP equals solo SP and SP1, a
migrated stream's KV and later chunks equal a never-migrated run's, and
a 2-lane session that really migrates and expands/releases SP equals the
1-lane session chunk for chunk.  Unlike the reference's lane tests these
run with the adaLN gates opened (``ardit.open_gates``): with the zero
gates of a fresh init every chunk ignores its KV context and a parity of
the context paths would hold vacuously.  The JAX parity test holds the
port's SP2 step to the reference's at 1e-5 (rtol and atol), fp32.

Torch's CPU matmul rounds a one-row product (a GEMV) differently from a
two-row one, and the time-embedding and adaLN modulation products are
[B, d] @ [d, n] with B the step's batch: a chunk computed as one row of
a two-row step differs in the last bits from the same chunk computed
alone.  So every bit-exact comparison here is between runs that step
each chunk with the same number of rows: the sessions serve one stream
per step (``max_batch=1``), and a batch-axis guest co-served with a
donor stream is held to the SP1 step co-served the same way.

Left out: the forced-device subprocess matrices
(``test_device_lanes.py::test_forced_{2,4}_device_parity_matrix``).
They run the reference with XLA's forced host devices, which torch has
no counterpart of; lanes on different devices wait for their slice.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import elastic_sp
from repro_torch.core.bmpr import StaticFidelity
from repro_torch.core.control_plane import TickDecisions
from repro_torch.core.elastic_sp import SPDecision
from repro_torch.core.fidelity import FidelityConfig
from repro_torch.core.rehoming import Migration
from repro_torch.core.state_plane import AsyncTransferEngine
from repro_torch.core.types import ClusterView, Stream, Worker
from repro_torch.models import ardit as A
from repro_torch.sched_sim.metrics import summarize, transfer_stats
from repro_torch.serve.batcher import BatchedChunkExecutor
from repro_torch.serve.lanes import LanePool
from repro_torch.serve.session import (SessionConfig, StreamingSession,
                                       uniform_specs)

torch.set_num_threads(2)

FID = FidelityConfig(2, 0.0, 2, "bf16")
DEV = "cpu"


def tiny_cfg(window_chunks=2):
    return dataclasses.replace(
        get_config("ardit-self-forcing").reduced(),
        n_layers=2, ardit_window_chunks=window_chunks)


def open_params(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return A.open_gates(A.init_params(cfg, g, DEV), g)


def lanes(n, cfg=None, params=None, **kw):
    cfg = cfg or tiny_cfg()
    return LanePool(n, cfg=cfg, params=open_params(cfg) if params is None
                    else params, device=DEV, **kw)


def gen_chunks(ex, sid, n=1, fid=FID, sp=False):
    """Drive one stream through n whole chunks on one executor
    (``sp=True`` = a reserved SP2 dispatch, the head-split path)."""
    out = []
    for _ in range(n):
        ex.begin_chunk(sid, fid, 0.0)
        while sid in ex.inflight:
            ex.run_step([sid], sp_serve=sp)
        out.append(ex.chunks[sid][-1].numpy().copy())
    return out


def session(n_lanes, pool, params=None, **kw):
    """A session of ``n_lanes`` lanes; with ``params``, over a ready
    ``LanePool`` of those params (the ``executor=`` injection)."""
    cfg = tiny_cfg()
    pool_ex = None if params is None else LanePool(
        n_lanes, cfg=cfg, params=params, max_streams=pool, device=DEV)
    return StreamingSession(
        SessionConfig(lanes=n_lanes, model_cfg=cfg, pool_streams=pool,
                      verbose=False, device=DEV, **kw),
        executor=pool_ex, fidelity_policy=StaticFidelity(FID))


def specs(chunks):
    """All-at-t=0 specs with the given per-stream chunk counts."""
    return [dataclasses.replace(s, frames=c * s.frames)
            for s, c in zip(uniform_specs(len(chunks), 1), chunks)]


# ---------------------------------------------------------------------------
# cross-lane migration: a real KV move, bit-exact
# ---------------------------------------------------------------------------

def test_cross_lane_migration_kv_bit_exact():
    """Migrating a stream moves its pages into the destination lane's
    pool verbatim, subsequent chunks are bit-identical to a never-
    migrated run, and the move shows up on the shared transfer engine."""
    ref_ex = lanes(1, max_streams=3).ex(0)
    ref_ex.admit(5, seed=0)
    ref = gen_chunks(ref_ex, 5, 4)

    lp = lanes(2, params=ref_ex.params, max_streams=3)
    lp.admit(5, 0, seed=0)
    got = gen_chunks(lp.ex(0), 5, 2)
    ctx_before = lp.ex(0).pool.gather([5], 2)[0].clone()
    n_log = len(lp.engine.log)

    assert lp.migrate(5, 0, 1)
    assert lp.lane_of[5] == 1
    assert not lp.ex(0).pool.resident(5)
    assert lp.ex(1).pool.resident(5)
    lp.ex(0).pool.ledger.check()
    lp.ex(1).pool.ledger.check()
    assert len(lp.engine.log) == n_log + 1     # ONE src->dst transfer
    assert torch.equal(ctx_before, lp.ex(1).pool.gather([5], 2)[0])
    assert lp.ex(0).pool.transfer_bytes_out == \
        lp.ex(1).pool.transfer_bytes_in > 0

    got += gen_chunks(lp.ex(1), 5, 2)
    for c, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(
            a, b, err_msg=f"chunk {c} diverged across the migration")
    assert lp.n_migrations == 1


def test_migration_refused_mid_chunk_or_wrong_lane():
    """The apply layer re-checks executor ground truth: a mid-chunk or
    wrongly-addressed migration decision is dropped, not applied."""
    lp = lanes(2, max_streams=3)
    lp.admit(0, 0, seed=0)
    gen_chunks(lp.ex(0), 0, 1)
    lp.ex(0).begin_chunk(0, FID, 0.0)
    lp.ex(0).run_step([0])                     # mid-chunk now
    assert not lp.migrate(0, 0, 1)             # boundary only
    assert not lp.migrate(0, 1, 0)             # stream is not on lane 1
    lp.ex(0).abort_chunk(0)
    assert lp.migrate(0, 0, 1)                 # boundary: applies


# ---------------------------------------------------------------------------
# elastic SP2: head-split step parity, donor mirror, release
# ---------------------------------------------------------------------------

def test_sp2_expand_release_numerical_parity_with_sp1():
    """The head-split SP2 step is bit-identical to the SP1 step (per-head
    attention never mixes heads and the donor's half mirrors the home
    pool verbatim), through expand, appends under SP, and release."""
    cfg = tiny_cfg()
    ref_ex = lanes(1, max_streams=3).ex(0)
    ref_ex.admit(0, seed=0)
    ref = gen_chunks(ref_ex, 0, 4)

    lp = lanes(2, params=ref_ex.params, max_streams=3)
    ex0 = lp.ex(0)
    lp.admit(0, 0, seed=0)
    got = gen_chunks(ex0, 0, 1)
    assert lp.sp_expand(0, 1)
    assert lp.sp_link(0) is not None and lp.sp_link(0).donor == 1
    # an UNRESERVED dispatch of a linked stream stays on the SP1 step:
    # the boundary it builds carries no SP marker
    ex0.begin_chunk(0, FID, 0.0)
    ex0.run_step([0])
    assert all(k[-1] is None for k in ex0._boundary_cache)
    ex0.abort_chunk(0)
    got += gen_chunks(ex0, 0, 2, sp=True)      # SP2 chunks (incl. appends)
    assert any(k[-1] == 1 for k in ex0._boundary_cache)

    # donor mirror: the donor pool's page set holds exactly the home
    # pool's upper half heads (kept in lockstep by the SP append)
    h2 = cfg.n_kv_heads // 2
    rows_h = torch.as_tensor(ex0.pool.ledger.tables[0])
    rows_d = torch.as_tensor(lp.ex(1).pool.ledger.tables[0])
    for pool_h, pool_d in ((ex0.pool.k, lp.ex(1).pool.k),
                           (ex0.pool.v, lp.ex(1).pool.v)):
        assert torch.equal(pool_h[:, rows_h][..., h2:, :],
                           pool_d[:, rows_d][..., h2:, :])

    lp.sp_release(0)
    assert lp.sp_link(0) is None
    lp.ex(1).pool.ledger.check()               # donor pages freed cleanly
    got += gen_chunks(ex0, 0, 1)               # back on the SP1 step
    for c, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(
            a, b, err_msg=f"chunk {c}: SP2 diverged from the SP1 step")
    assert lp.n_sp_expands == 1 and lp.n_sp_releases == 1


def test_sp_mirror_protected_from_donor_pool_eviction():
    """The donor lane's eviction paths must not see a live SP half-head
    mirror as an ordinary (non-inflight) resident and evict it
    mid-borrow."""
    lp = lanes(2, max_streams=2)
    streams = {}
    for sid, lane, ddl in ((0, 0, 9.0), (10, 1, 5.0), (11, 1, 4.0)):
        lp.admit(sid, lane, seed=sid)
        s = Stream(sid=sid, arrival=0.0, target_chunks=8,
                   chunk_seconds=1.0, home=lane, ttfc_slack=1.0)
        s.credit = ddl          # sid 0 has the HIGHEST credit: an
        streams[sid] = s        # unshielded pick would evict its mirror
    gen_chunks(lp.ex(0), 0, 1)
    # donor pool (lane 1) is full: expansion evicts a donor resident,
    # then mirrors stream 0's upper heads there
    assert lp.sp_expand(0, 1, streams)
    assert 0 in lp.ex(1).sp_mirrors
    assert lp.ex(1).pool.resident(0)
    # fresh pressure on the donor pool must NOT pick the mirror
    lp.ex(1).admit(12, seed=12, streams=streams)
    streams[12] = streams[11]
    assert lp.ex(1).pool.resident(0), \
        "live SP mirror was evicted from the donor pool"
    gen_chunks(lp.ex(0), 0, 1, sp=True)        # the SP2 step still runs
    lp.sp_release(0)
    assert 0 not in lp.ex(1).sp_mirrors
    lp.ex(1).pool.ledger.check()


def test_deferred_sp_release_blocks_same_tick_donor_reuse():
    """A release deferred to the next safe boundary (its stream
    mid-chunk) leaves the donor physically borrowed: the planner's
    same-tick rejoin must not re-grant it."""
    sess = session(2, 3)
    sess._t0 = 0.0
    sess.submit(uniform_specs(2, 4)[0])
    sess.submit(uniform_specs(2, 4)[1])
    sess._drain_events(0.0)                   # admit both
    h0 = sess.view.streams[0].home
    donor = 1 - h0
    gen_chunks(sess.lanes.ex(h0), 0, 1)
    assert sess.lanes.sp_expand(0, donor, sess.view.streams)
    elastic_sp.apply_expand(sess.view, SPDecision(0, donor, "expand"))
    sess.lanes.ex(h0).begin_chunk(0, FID, 0.0)   # mid-chunk: must defer
    sess._apply_decisions(TickDecisions(
        migrations=[],
        sp_decisions=[SPDecision(0, donor, "release"),
                      SPDecision(1, donor, "expand")],
        control_time_s=0.0))
    assert sess._pending_sp_release == {0: donor}
    assert sess.view.workers[donor].donated_to == 0
    assert sess.view.streams[1].sp_donor is None
    assert sess.lanes.sp_link(1) is None


def test_sp_expand_rejected_on_gather_backend():
    """The head split rides the paged step; on the gather backend the
    expand decision is dropped, never applied half-way."""
    lp = lanes(2, max_streams=3, context_backend="gather")
    lp.admit(0, 0, seed=0)
    gen_chunks(lp.ex(0), 0, 1)
    assert not lp.sp_expand(0, 1)
    assert lp.sp_link(0) is None


# ---------------------------------------------------------------------------
# prompt switch: fresh conditioning through KVPool.admit
# ---------------------------------------------------------------------------

def test_prompt_switch_serves_fresh_conditioning():
    """The post-switch chunk differs from the no-switch chunk and equals
    a fresh stream's first chunk under the new conditioning seed."""
    cfg = tiny_cfg()
    p = open_params(cfg)
    ex = BatchedChunkExecutor(cfg=cfg, params=p, max_streams=3, device=DEV)
    ex.admit(7, seed=7)
    gen_chunks(ex, 7, 1)
    assert ex.reset_condition(7, seed=777)
    ex.pool.ledger.check()
    post = gen_chunks(ex, 7, 1)[0]

    no_switch = BatchedChunkExecutor(cfg=cfg, params=p, max_streams=3,
                                     device=DEV)
    no_switch.admit(7, seed=7)
    gen_chunks(no_switch, 7, 1)
    stale = gen_chunks(no_switch, 7, 1)[0]
    assert not np.array_equal(post, stale), \
        "post-switch chunk still serves the OLD conditioning"

    fresh = BatchedChunkExecutor(cfg=cfg, params=p, max_streams=3,
                                 device=DEV)
    fresh.admit(7, seed=777)
    np.testing.assert_array_equal(post, gen_chunks(fresh, 7, 1)[0])


def test_session_prompt_switch_resets_condition_and_completes():
    from repro_torch.sched_sim.workloads import StreamSpec
    sess = session(1, 3)
    h = sess.submit(StreamSpec(0, 0.0, 48, switches=(0.02,)))
    sess.run()
    assert h.done and h.chunks_ready == 4
    assert sess._switches.get(0) == 1
    assert sess.switch_seed(0) == 0 + 100003


# ---------------------------------------------------------------------------
# the lane-aware session: decisions -> apply -> metrics, bit-identical
# ---------------------------------------------------------------------------

def _ref_chunks(chunks, params):
    """Every stream's chunks from a 1-lane session, one stream per step."""
    ref = session(1, len(chunks) + 1, params, max_batch=1)
    for spec in specs(chunks):
        ref.submit(spec)
    ref.run()
    return {i: [c.numpy() for c in ref.handles[i].chunks]
            for i in range(len(chunks))}


def _assert_same_chunks(sess, ref, chunks):
    for i, n_chunks in enumerate(chunks):
        got = [c.numpy() for c in sess.handles[i].chunks]
        assert len(got) == n_chunks
        for c in range(n_chunks):
            np.testing.assert_array_equal(
                ref[i][c], got[c], err_msg=f"stream {i} chunk {c} diverged "
                                           f"from the single-lane session")


def test_multi_lane_session_applies_decisions_bit_identically():
    """A 2-lane session that REALLY migrates one stream and REALLY
    expands + releases SP on another produces, under a fixed fidelity,
    chunks bit-identical to the single-lane session, and reports the
    applied counts on the metrics surface."""
    n, chunks = 2, 3
    p = open_params(tiny_cfg())
    ref = _ref_chunks([chunks] * n, p)
    sess = session(2, n + 1, p, max_batch=1)
    assert sess.lanes.n_lanes == 2 and sess.control.config.use_elastic_sp
    for spec in specs([chunks] * n):
        sess.submit(spec)
    # force one migration and one SP expand/release through the SAME
    # tick -> apply path the control plane uses
    state = {"mig": False, "sp": False, "rel": False}
    orig_tick = sess.control.tick

    def tick(view, now):
        d = orig_tick(view, now)
        s0, s1 = view.streams.get(0), view.streams.get(1)
        if (not state["mig"] and s0 is not None and s0.chunks_done >= 1
                and not s0.done and not sess.lanes.is_inflight(0)):
            src = sess.lanes.lane_of[0]
            d.migrations.append(Migration(0, src, 1 - src,
                                          cross_node=False))
            state["mig"] = True
        if (not state["sp"] and s1 is not None and s1.chunks_done >= 1
                and not s1.done
                and sess.lanes.ex(sess.lanes.lane_of[1]).pool.resident(1)):
            d.sp_decisions.append(
                SPDecision(1, 1 - sess.lanes.lane_of[1], "expand"))
            state["sp"] = True
        elif (state["sp"] and not state["rel"] and s1 is not None
                and not s1.done and s1.sp_donor is not None
                and s1.chunks_done >= 2):
            d.sp_decisions.append(SPDecision(1, s1.sp_donor, "release"))
            state["rel"] = True
        return d

    sess.control.tick = tick
    res = sess.run()
    assert res.n_migrations_applied >= 1
    assert res.n_sp_expands_applied >= 1
    assert res.n_sp_releases_applied >= 1      # explicit or at retire
    assert all(w.donated_to is None for w in sess.view.workers)
    for ex in sess.lanes.executors:
        ex.pool.ledger.check()
    _assert_same_chunks(sess, ref, [chunks] * n)
    assert transfer_stats(res)["n"] == len(res.engine.log) >= 2
    s = summarize(res)
    assert s.n_chunks == n * chunks and 0.0 <= s.qoe <= 1.0


def test_multi_lane_session_oversubscribed_completes():
    """2 lanes x 2-resident pools serving 6 streams: per-lane
    credit-aware eviction keeps rotating everyone through."""
    n, chunks = 6, 2
    sess = session(2, 2, max_batch=2)
    for spec in uniform_specs(n, chunks):
        sess.submit(spec)
    res = sess.run()
    assert all(res.streams[i].chunks_done == chunks for i in range(n))
    assert len(sess.view.workers) == 2
    for ex in sess.lanes.executors:
        ex.pool.ledger.check()


# ---------------------------------------------------------------------------
# test_device_lanes.py, same-device part
# ---------------------------------------------------------------------------

def test_sp_expand_bytes_attributed_src_out_dst_in():
    lp = lanes(2, max_streams=3)
    lp.admit(0, 0, seed=0)
    gen_chunks(lp.ex(0), 0, 1)
    home_pool, donor_pool = lp.ex(0).pool, lp.ex(1).pool
    assert home_pool.transfer_bytes == 0 == donor_pool.transfer_bytes
    assert lp.sp_expand(0, 1)
    assert home_pool.transfer_bytes_out > 0
    assert donor_pool.transfer_bytes_in == home_pool.transfer_bytes_out
    assert home_pool.transfer_bytes_in == 0
    assert donor_pool.transfer_bytes_out == 0


def test_spill_restore_split_by_direction():
    ex = lanes(1, max_streams=1).ex(0)
    streams = {}
    for sid in (0, 1):
        s = Stream(sid=sid, arrival=0.0, target_chunks=4, chunk_seconds=1.0,
                   home=0, ttfc_slack=1.0)
        s.credit = float(sid)
        streams[sid] = s
        ex.admit(sid, seed=sid, streams=streams)
    assert ex.pool.transfer_bytes_out > 0      # admitting 1 evicted 0
    out_before = ex.pool.transfer_bytes_out
    assert ex.ensure_resident(0, streams)
    assert ex.pool.transfer_bytes_in > 0
    assert ex.pool.transfer_bytes == \
        ex.pool.transfer_bytes_in + ex.pool.transfer_bytes_out
    assert ex.pool.transfer_bytes_out > out_before    # 1 spilled out


def test_measured_moves_calibrate_bw_intra():
    eng = AsyncTransferEngine(bw_intra=200e9, n_layers=2)
    assert eng.measured_stats()["count"] == 0
    eng.record_measured(1000, 1e-6, kind="migration")   # 1e9 B/s
    assert eng.bw_intra == pytest.approx(1e9)
    assert eng.bw_intra_model == 200e9
    eng.record_measured(3000, 1e-6, kind="sp-expand")   # 3e9 B/s
    assert eng.bw_intra == pytest.approx(0.5 * 1e9 + 0.5 * 3e9)
    st = eng.measured_stats()
    assert st["count"] == 2 and st["bytes"] == 4000
    assert st["bytes_per_s"] == pytest.approx(4000 / 2e-6)
    t = eng.transfer(0.0, 2_000_000, cross_node=False)
    assert t.total == pytest.approx(eng.overhead + 2_000_000 / eng.bw_intra)
    frozen = AsyncTransferEngine(bw_intra=200e9, calibrate=False)
    frozen.record_measured(1000, 1e-6)
    assert frozen.bw_intra == 200e9
    assert len(frozen.measured) == 1


def test_t_next_is_a_validated_duration():
    s = Stream(sid=0, arrival=0.0, target_chunks=4, chunk_seconds=1.0,
               home=0, ttfc_slack=1.0)
    assert s.t_next == 0.0
    s.t_next = 0.25
    assert s.t_next == 0.25
    for bogus in (-0.1, float("inf"), float("nan"), -1e9):
        with pytest.raises(ValueError):
            s.t_next = bogus
    assert s.t_next == 0.25


def test_t_next_guard_semantics_in_release_plan():
    s = Stream(sid=0, arrival=0.0, target_chunks=8, chunk_seconds=1.0,
               home=0, ttfc_slack=1.0)
    s.sp_donor = 1
    view = ClusterView({0: s}, [Worker(0, 0), Worker(1, 0)],
                       workers_per_node=2)
    view.workers[1].donated_to = 0
    s.t_next = 0.0                         # no estimate: guard must hold
    s.credit = 100.0
    assert not any(d.kind == "release"
                   for d in elastic_sp.plan_elastic_sp(view, 0.0))
    s.t_next = 0.5                         # T_u duration; C_u >= 2*T_u
    assert any(d.kind == "release"
               for d in elastic_sp.plan_elastic_sp(view, 0.0))


def test_warmup_calibration_stream_fully_purged():
    """The sid -1 calibration chunk ran on lane 0 only: no per-stream
    state may survive, and lane 0's priors equal every other lane's."""
    sess = session(2, 3)
    ex0, ex1 = sess.lanes.ex(0), sess.lanes.ex(1)
    for ex in (ex0, ex1):
        assert -1 not in ex.chunks and -1 not in ex.fidelity_log
        assert -1 not in ex.chunk_seq and -1 not in ex.inflight
        assert -1 not in ex._pending_wait
        assert -1 not in ex.pool.ledger.tables
        assert -1 not in ex.pool.ledger.chunks
        assert -1 not in ex.pool.ledger.spilled
        assert -1 not in ex.pool._dev_tables and -1 not in ex.pool._spill
        ex.pool.ledger.check()
    assert ex0.pool.free_pages == ex0.pool.n_pages
    assert ex0.latency_ema == ex1.latency_ema
    assert ex0.step_ema == ex1.step_ema
    assert sess.top_latency > 0.0


def test_sequential_warmup_purged():
    sess = StreamingSession(
        SessionConfig(executor="sequential", model_cfg=tiny_cfg(),
                      verbose=False, device=DEV),
        fidelity_policy=StaticFidelity(FID))
    ex = sess.executor
    assert -1 not in ex.streams and -1 not in ex.chunks
    assert -1 not in ex.fidelity_log and -1 not in ex.inflight
    assert sess.top_latency > 0.0


def test_batch_axis_sp_equals_solo_sp_and_sp1():
    """Forced ``sp_mode="batch"``: the borrowed stream is co-served as a
    donor batch row and its chunks are bit-identical to both the solo
    head-split path and plain SP1 — through expand, appends under SP,
    and release (the home pool stays the system of record).  The chunk
    the guest computes beside a donor stream is held to SP1 computing it
    beside the same stream (see the module docstring)."""
    ref_ex = lanes(1, max_streams=3).ex(0)
    ref_ex.admit(0, seed=0)
    ref = gen_chunks(ref_ex, 0, 4)                      # SP1 reference
    co_ex = lanes(1, params=ref_ex.params, max_streams=3).ex(0)
    co_ex.admit(0, seed=0)
    co_ex.admit(9, seed=9)
    co = gen_chunks(co_ex, 0, 1)
    co_ex.begin_chunk(0, FID, 0.0)
    co_ex.begin_chunk(9, FID, 0.0)
    while 0 in co_ex.inflight:
        co_ex.run_step([0, 9])
    co.append(co_ex.chunks[0][-1].numpy().copy())
    co += gen_chunks(co_ex, 0, 2)                       # SP1, co-served

    solo = lanes(2, params=ref_ex.params, max_streams=3)
    solo.admit(0, 0, seed=0)
    got_solo = gen_chunks(solo.ex(0), 0, 1)
    assert solo.sp_expand(0, 1)
    assert solo.sp_link(0).mode == "solo"               # the default
    got_solo += gen_chunks(solo.ex(0), 0, 2, sp=True)
    solo.sp_release(0)
    got_solo += gen_chunks(solo.ex(0), 0, 1)

    batch = lanes(2, params=ref_ex.params, max_streams=3, sp_mode="batch")
    batch.admit(0, 0, seed=0)
    batch.admit(9, 1, seed=9)                           # donor's own work
    got_batch = gen_chunks(batch.ex(0), 0, 1)
    assert batch.sp_expand(0, 1)
    link = batch.sp_link(0)
    assert link is not None and link.mode == "batch"
    assert 0 in batch.ex(1).sp_guests
    assert batch.serving_ex(0) is batch.ex(1)           # guest routed
    donor_ex = batch.ex(1)
    # ONE call co-serves the guest and the donor's own stream
    donor_ex.begin_chunk(0, FID, 0.0)
    donor_ex.begin_chunk(9, FID, 0.0)
    while 0 in donor_ex.inflight:
        donor_ex.run_step([0, 9])
    assert 9 not in donor_ex.inflight
    got_batch.append(donor_ex.chunks[0][-1].numpy().copy())
    got_batch += gen_chunks(donor_ex, 0, 1)
    # the home pool tracked every guest append (system of record)
    rows_h = torch.as_tensor(batch.ex(0).pool.ledger.tables[0])
    rows_d = torch.as_tensor(donor_ex.pool.ledger.tables[0])
    assert torch.equal(batch.ex(0).pool.k[:, rows_h],
                       donor_ex.pool.k[:, rows_d])
    batch.sp_release(0)
    assert 0 not in donor_ex.sp_guests
    assert 0 not in donor_ex.chunk_seq and 0 not in donor_ex.chunks
    donor_ex.pool.ledger.check()
    got_batch += gen_chunks(batch.ex(0), 0, 1)          # home continues
    for c in range(4):
        np.testing.assert_array_equal(
            ref[c], got_solo[c],
            err_msg=f"chunk {c}: solo SP2 diverged from SP1")
        np.testing.assert_array_equal(
            co[c], got_batch[c],
            err_msg=f"chunk {c}: batch-axis SP diverged from SP1")
    # batch against solo: equal until the co-served chunk, within the
    # GEMV's rounding from it on (its KV feeds the later chunks)
    np.testing.assert_array_equal(got_solo[0], got_batch[0])
    for c in range(1, 4):
        np.testing.assert_allclose(got_batch[c], got_solo[c], rtol=1e-5,
                                   atol=1e-5)


def test_batch_linked_stream_must_not_run_at_home():
    lp = lanes(2, max_streams=3, sp_mode="batch")
    lp.admit(0, 0, seed=0)
    gen_chunks(lp.ex(0), 0, 1)
    assert lp.sp_expand(0, 1)
    ex0 = lp.ex(0)
    ex0.begin_chunk(0, FID, 0.0)
    with pytest.raises(AssertionError, match="donor lane"):
        ex0.run_step([0])
    ex0.abort_chunk(0)
    lp.sp_release(0)


def test_batch_guest_protected_from_donor_eviction():
    lp = lanes(2, max_streams=2, sp_mode="batch")
    streams = {}
    for sid, lane, credit in ((0, 0, 9.0), (10, 1, 5.0), (11, 1, 4.0)):
        lp.admit(sid, lane, seed=sid)
        s = Stream(sid=sid, arrival=0.0, target_chunks=8, chunk_seconds=1.0,
                   home=lane, ttfc_slack=1.0)
        s.credit = credit
        streams[sid] = s
    gen_chunks(lp.ex(0), 0, 1)
    assert lp.sp_expand(0, 1, streams)
    assert lp.ex(1).pool.resident(0)
    lp.ex(1).admit(12, seed=12, streams=streams)
    streams[12] = streams[11]
    assert lp.ex(1).pool.resident(0), \
        "batch-axis guest evicted from the donor pool mid-borrow"
    assert lp.ex(0).pool.resident(0), \
        "linked stream's home pages evicted mid-borrow"
    gen_chunks(lp.ex(1), 0, 1)                  # guest still serves
    lp.sp_release(0)


def test_multi_lane_session_batch_mode_bit_identical():
    """A 2-lane session with ``sp_mode="batch"`` (the guest rerouted
    through ``_dispatch_round`` onto the donor's micro-batch) completes
    bit-identical to the single-lane session under a forced expand.
    Stream 0 (the donor lane's own) has one chunk, so the guest's rows
    run alone on the donor as they do in the reference session."""
    chunks = [1, 3]
    p = open_params(tiny_cfg())
    ref = _ref_chunks(chunks, p)
    sess = session(2, 3, p, max_batch=1)
    sess.lanes.sp_mode = "batch"
    for spec in specs(chunks):
        sess.submit(spec)
    state = {"sp": False}
    orig_tick = sess.control.tick

    def tick(view, now):
        d = orig_tick(view, now)
        s1 = view.streams.get(1)
        if (not state["sp"] and s1 is not None and s1.chunks_done >= 1
                and not s1.done
                and sess.lanes.ex(sess.lanes.lane_of[1]).pool.resident(1)):
            d.sp_decisions.append(
                SPDecision(1, 1 - sess.lanes.lane_of[1], "expand"))
            state["sp"] = True
        return d

    sess.control.tick = tick
    res = sess.run()
    assert res.n_sp_expands_applied >= 1
    assert sum(len(ex.effective_window_log.get(1, ()))
               for ex in sess.lanes.executors) == 3
    assert len(sess.lanes.ex(1 - res.streams[1].home)
               .effective_window_log.get(1, ())) >= 1   # served as a guest
    _assert_same_chunks(sess, ref, chunks)
    for ex in sess.lanes.executors:
        ex.pool.ledger.check()
        assert not ex.sp_guests and not ex.sp_links


def test_direct_export_import_pages_bit_exact():
    """The direct landing (``export_stream(to_host=False)`` ->
    ``import_stream(direct=True)`` -> ``KVPool.import_pages``): the
    pages stay tensors on the pool's device, land resident at once, and
    the stream continues bit-identically to a never-moved run."""
    cfg = tiny_cfg()
    p = open_params(cfg)
    ref_ex = BatchedChunkExecutor(cfg=cfg, params=p, max_streams=3,
                                  device=DEV)
    ref_ex.admit(3, seed=3)
    ref = gen_chunks(ref_ex, 3, 3)
    src = BatchedChunkExecutor(cfg=cfg, params=p, max_streams=3, device=DEV)
    dst = BatchedChunkExecutor(cfg=cfg, params=p, max_streams=3, device=DEV)
    src.admit(3, seed=3)
    got = gen_chunks(src, 3, 2)
    ctx = src.pool.gather([3], 2)[0].clone()
    state = src.export_stream(3, to_host=False)
    assert not src.pool.resident(3) and 3 not in src.chunks
    dst.import_stream(3, state, direct=True)
    assert dst.pool.resident(3) and not dst.pool.spilled(3)
    assert torch.equal(dst.pool.gather([3], 2)[0], ctx)
    assert dst.pool.transfer_bytes_in > 0
    src.pool.ledger.check()
    dst.pool.ledger.check()
    got += gen_chunks(dst, 3, 1)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_lanes_on_other_devices_wait():
    """The cross-device paths (direct migration, device-forced batch SP)
    raise until their slice, instead of quietly taking another path."""
    lp = lanes(2, max_streams=3)
    lp.admit(0, 0, seed=0)
    gen_chunks(lp.ex(0), 0, 1)
    lp.ex(1).device = torch.device("meta")
    with pytest.raises(NotImplementedError, match="different devices"):
        lp.migrate(0, 0, 1)
    with pytest.raises(NotImplementedError, match="different devices"):
        lp.sp_expand(0, 1)
    with pytest.raises(ValueError, match="sp_mode"):
        lanes(2, sp_mode="auto")
    assert lp.lane_of[0] == 0 and lp.ex(0).pool.resident(0)
    assert lp.sp_link(0) is None


# ---------------------------------------------------------------------------
# the SP2 step against the JAX reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_denoise_step_paged_sp_matches_jax(masked):
    """``denoise_step_paged_sp`` on the same params, pools, tables and
    masks as the reference's: x_new and the chunk's clean KV within
    1e-5, and equal to the port's own SP1 step when the donor pool
    mirrors the home pool's upper heads."""
    from repro.models import ardit as JA
    from repro.models import kvcache as JK
    from repro_torch.models.convert import params_from_numpy

    from test_batcher import nondegenerate_params
    from test_torch_layers import _cfgs
    jcfg, tcfg = _cfgs(n_layers=2, ardit_window_chunks=2)
    jp = nondegenerate_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(int(masked))
    tc = JA.chunk_tokens(jcfg)
    page = max(JA.COND_TOKENS, tc)
    shape = (jcfg.n_layers, 8, page, jcfg.n_kv_heads, jcfg.head_dim)
    kh = rng.standard_normal(shape, dtype=np.float32)
    vh = rng.standard_normal(shape, dtype=np.float32)
    kd = rng.standard_normal(shape, dtype=np.float32)
    vd = rng.standard_normal(shape, dtype=np.float32)
    th = np.asarray([[5, 1, 6], [2, 7, 3]], np.int32)
    td = np.asarray([[0, 4, 2], [6, 1, 5]], np.int32)
    h2 = jcfg.n_kv_heads // 2
    # the donor pages mirror the home pages' upper heads
    kd[:, td, :, h2:] = kh[:, th, :, h2:]
    vd[:, td, :, h2:] = vh[:, th, :, h2:]
    x = rng.standard_normal((2, tc, JA.LATENT_CH), dtype=np.float32)
    t = np.asarray([0.75, 0.0], np.float32)
    dt = np.asarray([0.25, 0.0], np.float32)
    is_dn = np.asarray([True, False])
    q_off = (JA.COND_TOKENS + np.asarray([2, 1]) * tc).astype(np.int32)
    dn = cl = None
    if masked:
        m = JA.batched_context_mask_multi(
            jcfg, np.asarray([2, 1]), np.asarray([1, 2]),
            np.asarray([0.5, 0.0]))[:, :JA.COND_TOKENS + 2 * tc]
        dn = JK.mask_to_pages(m, 2, JA.COND_TOKENS, tc, page)
        cl = ~dn & (rng.random(dn.shape) < 0.5) | dn
    j = JA.denoise_step_paged_sp(
        jcfg, jp, *(None if a is None else jax.numpy.asarray(a)
                    for a in (x, t, dt, kh, vh, kd, vd, th, td, dn, cl,
                              q_off, is_dn)))
    targs = [None if a is None else torch.from_numpy(np.asarray(a))
             for a in (x, t, dt, kh, vh, kd, vd, th, td, dn, cl, q_off,
                       is_dn)]
    x1, kv1 = A.denoise_step_paged_sp(tcfg, tp, *targs)
    np.testing.assert_allclose(x1.numpy(), np.asarray(j[0]),
                               rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(kv1[name].numpy(),
                                   np.asarray(j[1][name]),
                                   rtol=1e-5, atol=1e-5)
    # the port's SP1 step over the home pool alone gives the same
    x0, kv0 = A.denoise_step_paged(
        tcfg, tp, targs[0], targs[1], targs[2], targs[3], targs[4],
        targs[7], targs[9], targs[10], targs[11], targs[12])
    assert torch.equal(x0, x1) and torch.equal(kv0["k"], kv1["k"])


def test_pool_write_pages_heads_matches_jax():
    """The donor pool's head-sliced append, in place, against the
    reference's functional one."""
    from repro.models import kvcache as JK
    from repro_torch.models import kvcache as TK
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((2, 5, 6, 4, 8), dtype=np.float32)
    new = rng.standard_normal((2, 2, 3, 2, 8), dtype=np.float32)
    pages = np.asarray([3, 1], np.int32)
    want = np.asarray(JK.pool_write_pages_heads(
        jax.numpy.asarray(pool), jax.numpy.asarray(new),
        jax.numpy.asarray(pages), 2))
    got = torch.from_numpy(pool.copy())
    TK.pool_write_pages_heads(got, torch.from_numpy(new), pages, 2)
    np.testing.assert_array_equal(got.numpy(), want)
