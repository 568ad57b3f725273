"""Lanes on different devices, on the card: a lane on ``cuda`` beside a
lane on ``cpu`` (``LanePool(devices=["cuda", "cpu"])``) and, where two
cards are visible, a lane on each (``["cuda:0", "cuda:1"]``, as
``launch/serve.py --device-count 2`` places them), the reduced
``ardit-self-forcing`` config (2 layers, fp32, TF32 off, the adaLN
gates opened), against lanes on one device.  Where two cards are
visible, each kernel wrapper also launches on the second card while the
first is current (the launch follows its tensors' device).

Marked ``cuda``: each test skips on a host without an NVIDIA GPU.  This
file imports no JAX::

    python -m pytest -q --noconftest -m cuda \
        tests/test_torch_device_lanes_cuda.py

* A migration either way is a real move between the devices (``_measured_put``, one
  measured move on the engine, ``bw_intra`` calibrated from it) and the
  pages arrive bit for bit.
* Batch-axis SP (``sp_mode="auto"`` takes it for the pair): the guest's
  chunk, computed on the donor's device, matches the never-borrowed
  stream's on its home device within the executor tolerance, 1e-4; its
  KV ships back to the home pool.
* A 2-device session that migrates one stream and borrows another
  matches a 1-lane session on the card within 1e-4.

The card and the CPU round differently, so the chunks are held to 1e-4,
not bit for bit; moved pages are bit for bit.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

pytestmark = pytest.mark.cuda

FID_STEPS, FID_WINDOW = 2, 2
TOL = 1e-4


PAIRS = {"card+cpu": ("cuda:0", "cpu"), "two cards": ("cuda:0", "cuda:1")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.fixture(params=list(PAIRS))
def pair(request, card):
    devices = PAIRS[request.param]
    if devices[1].startswith("cuda") and torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    return [torch.device(d) for d in devices]


def _cfg():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("ardit-self-forcing").reduced(),
                               n_layers=2, ardit_window_chunks=2)


def _params(cfg):
    from repro_torch.models import ardit as A
    g = torch.Generator().manual_seed(0)
    return A.open_gates(A.init_params(cfg, g, "cpu"), g)


def _fid():
    from repro_torch.core.fidelity import FidelityConfig
    return FidelityConfig(FID_STEPS, 0.0, FID_WINDOW, "bf16")


def _chunks(ex, sid, n):
    out = []
    for _ in range(n):
        ex.begin_chunk(sid, _fid(), 0.0)
        while sid in ex.inflight:
            ex.run_step([sid])
        out.append(ex.chunks[sid][-1].detach().cpu())
    return out


def _close(got, want):
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).abs().max()) <= TOL


def test_migration_across_the_pair_is_a_measured_bitwise_move(pair):
    from repro_torch.serve.lanes import LanePool
    cfg = _cfg()
    lp = LanePool(2, cfg=cfg, params=_params(cfg), max_streams=2,
                  devices=pair)
    assert [ex.pool.device for ex in lp.executors] == pair
    lp.admit(0, 0, seed=0)
    _chunks(lp.ex(0), 0, 2)
    pool0 = lp.ex(0).pool
    page_bytes = 2 * pool0.k[:, :pool0.pages_per_stream].numel() * 4
    for src, dst in ((0, 1), (1, 0)):
        ctx = [t.cpu() for t in lp.ex(src).pool.gather([0], 2)]
        n = len(lp.engine.measured)
        assert lp.migrate(0, src, dst)
        assert lp.ex(dst).pool.resident(0) and not lp.ex(dst).pool.spilled(0)
        got = [t.cpu() for t in lp.ex(dst).pool.gather([0], 2)]
        assert all(torch.equal(a, b) for a, b in zip(got, ctx))
        (m,) = lp.engine.measured[n:]
        assert m.kind == "migration" and m.n_bytes == page_bytes
        assert m.seconds > 0
    assert lp.engine.bw_intra != lp.engine.bw_intra_model


def test_batch_axis_sp_across_the_pair_matches_sp1(card, pair):
    from repro_torch.serve.batcher import BatchedChunkExecutor
    from repro_torch.serve.lanes import LanePool
    cfg = _cfg()
    p = _params(cfg)
    ref_ex = BatchedChunkExecutor(cfg=cfg, params=p, max_streams=2,
                                  device=card)
    ref_ex.admit(0, seed=0)
    ref = _chunks(ref_ex, 0, 3)
    lp = LanePool(2, cfg=cfg, params=p, max_streams=2, devices=pair)
    lp.admit(0, 0, seed=0)
    got = _chunks(lp.ex(0), 0, 2)
    assert lp.sp_expand(0, 1) and lp.sp_link(0).mode == "batch"
    assert lp.engine.measured[-1].kind == "sp-expand"
    got += _chunks(lp.ex(1), 0, 1)              # the guest row, on pair[1]
    assert lp.ex(0).pool.chunks[0] == 3         # shipped back home
    lp.sp_release(0)
    _close(got, ref)
    for ex in lp.executors:
        ex.pool.ledger.check()


def test_two_device_session_matches_one_lane(card, pair):
    from repro_torch.core.bmpr import StaticFidelity
    from repro_torch.core.elastic_sp import SPDecision
    from repro_torch.core.rehoming import Migration
    from repro_torch.serve.lanes import LanePool
    from repro_torch.serve.session import (SessionConfig, StreamingSession,
                                           uniform_specs)
    cfg = _cfg()
    p = _params(cfg)

    def serve(devices, force):
        pool = LanePool(len(devices), cfg=cfg, params=p, max_streams=3,
                        devices=devices)
        sess = StreamingSession(
            SessionConfig(model_cfg=cfg, lanes=len(devices), max_batch=1,
                          verbose=False, device=card),
            executor=pool, fidelity_policy=StaticFidelity(_fid()))
        for spec in uniform_specs(2, 3):
            sess.submit(spec)
        if force:
            state = {"mig": False, "sp": False, "rel": False}
            orig = sess.control.tick

            def tick(view, now):
                d = orig(view, now)
                s0, s1 = view.streams.get(0), view.streams.get(1)
                if (not state["mig"] and s0 is not None
                        and s0.chunks_done >= 1 and not s0.done
                        and not pool.is_inflight(0)):
                    src = pool.lane_of[0]
                    d.migrations.append(Migration(0, src, 1 - src,
                                                  cross_node=False))
                    state["mig"] = True
                if (not state["sp"] and s1 is not None
                        and s1.chunks_done >= 1 and not s1.done
                        and pool.ex(pool.lane_of[1]).pool.resident(1)):
                    d.sp_decisions.append(
                        SPDecision(1, 1 - pool.lane_of[1], "expand"))
                    state["sp"] = True
                elif (state["sp"] and not state["rel"] and s1 is not None
                        and not s1.done and s1.sp_donor is not None
                        and s1.chunks_done >= 2):
                    d.sp_decisions.append(SPDecision(1, s1.sp_donor,
                                                     "release"))
                    state["rel"] = True
                return d

            sess.control.tick = tick
        res = sess.run()
        return res, {sid: [c.detach().cpu() for c in sess.handles[sid].chunks]
                     for sid in (0, 1)}

    _, ref = serve([card], False)
    res, two = serve(pair, True)
    assert res.n_migrations_applied >= 1 and res.n_sp_expands_applied >= 1
    assert res.n_sp_releases_applied >= 1
    assert {m.kind for m in res.engine.measured} == {"migration",
                                                     "sp-expand"}
    for sid in (0, 1):
        assert len(two[sid]) == 3
        _close(two[sid], ref[sid])
    assert np.isfinite(res.engine.bw_intra)


def test_kernels_launch_on_their_tensors_card(card):
    """With the first card current, each kernel wrapper given tensors on
    the second card launches there (the runtime's current device follows
    the tensors) and agrees with its plain version on the same tensors:
    flash (tensor cores and CUDA cores), paged chunk attention, paged
    decode, fp8 matmul and the SSD scan."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    from repro_torch.kernels.fp8_matmul import ops as f8ops, ref as f8ref
    from repro_torch.kernels.paged_attention import ops as pops, ref as pref
    from repro_torch.kernels.ssd_scan import ops as sops, ref as sref
    dev = torch.device("cuda:1")
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def close(got, want, tol):
        assert got.device == dev
        assert float((got.float() - want.float()).abs().max()) <= tol * max(
            1.0, float(want.float().abs().max()))

    with torch.cuda.device(card):
        for dtype, d in ((torch.bfloat16, 64), (torch.float32, 16)):
            q, k, v = rnd(2, 130, 4, d, dtype=dtype), \
                rnd(2, 300, 4, d, dtype=dtype), rnd(2, 300, 4, d, dtype=dtype)
            close(fops.flash_mha(q, k, v, n_kv_heads=4, causal=False),
                  fref.flash_mha_ref(q, k, v, n_kv_heads=4, causal=False),
                  2e-2 if dtype == torch.bfloat16 else 1e-4)
        q = rnd(1, 40, 2, 16)
        kp, vp = rnd(5, 77, 2, 16), rnd(5, 77, 2, 16)
        table = torch.tensor([[3, 0, 4]], dtype=torch.int32, device=dev)
        hint = dict(sink=77, chunk_tokens=77)
        got = pops.paged_chunk_attention(q, kp, vp, table, None, **hint)
        want = pref.paged_chunk_attention_ref(q, kp, vp, table, None, **hint)
        for a, b in zip(got, want):
            close(a, b, 1e-4)
        qd = rnd(2, 4, 64)
        kd, vd = rnd(9, 16, 2, 64), rnd(9, 16, 2, 64)
        tab = torch.tensor([[1, 5, 7], [0, 2, 8]], dtype=torch.int32,
                           device=dev)
        ln = torch.tensor([40, 17], dtype=torch.int32, device=dev)
        close(pops.paged_decode_attention(qd, kd, vd, tab, ln),
              pref.paged_decode_attention_ref(qd, kd, vd, tab, ln), 1e-5)
        x = rnd(64, 128).to(torch.float8_e4m3fn)
        w = rnd(128, 64).to(torch.float8_e4m3fn)
        sx, sw = rnd(64, 1).abs(), rnd(1, 64).abs()
        close(f8ops.fp8_scaled_matmul(x, w, sx, sw),
              f8ref.fp8_matmul_ref(x, w, sx, sw), 1e-5)
        xs = rnd(1, 40, 2, 16)
        dt = rnd(1, 40, 2).abs() * 0.1
        A = -rnd(2).abs()
        Bm, Cm = rnd(1, 40, 1, 16), rnd(1, 40, 1, 16)
        ys, fs = sops.ssd(xs, dt, A, Bm, Cm, chunk=16)
        yr, fr = sref.ssd_ref(xs, dt, A, Bm, Cm, chunk=16)
        close(ys, yr, 1e-4)
        close(fs, fr, 1e-4)
        assert torch.cuda.current_device() == card.index
