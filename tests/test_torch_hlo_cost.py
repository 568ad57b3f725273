"""The port's per-device cost counter (``repro_torch.launch.hlo_cost``),
which counts the aten ops of one rank at the dispatcher where the
reference reads optimized HLO.

* The reference's ``tests/test_sharding.py::TestHloCost`` on the port: a
  product is exactly 2*M*N*K, L products in a Python loop (the
  reference's scan) are L times one, L x R nested products L*R times,
  and the bytes lie between one product's operands and a bound that
  grows with L.
* On a fake 256-rank (16, 16) mesh, x [64, 4096] with its batch over
  ``data`` times w [4096, 16384] over (``data``, ``model``) is
  2*4*4096*1024 = 33,554,432 FLOPs per device, exactly, twice in a row:
  the sharding propagator's fake ops on GLOBAL shapes (run on an op's
  first use only, then cached) are not counted, so the count does not
  depend on call order.
"""
import pytest

pytest.importorskip("torch")

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch import hlo_cost
from repro_torch.launch.lowering import fake_world
from repro_torch.launch.mesh import make_production_mesh


class TestHloCost:
    def test_matmul_exact(self):
        M, N, K = 64, 32, 128
        a, b = torch.zeros(M, K), torch.zeros(K, N)
        assert hlo_cost.analyze(lambda: a @ b).flops == 2 * M * N * K

    def test_loop_of_products_multiplied(self):
        L, M = 5, 32
        x, ws = torch.zeros(M, M), torch.zeros(L, M, M)

        def f():
            h = x
            for w in ws:
                h = h @ w
            return h
        assert hlo_cost.analyze(f).flops == L * 2 * M ** 3

    def test_nested_loops(self):
        L, R, M = 4, 3, 16
        x, ws = torch.zeros(M, M), torch.zeros(L, M, M)

        def f():
            h = x
            for w in ws:
                for _ in range(R):
                    h = h @ w
            return h
        assert hlo_cost.analyze(f).flops == L * R * 2 * M ** 3

    def test_hbm_bytes_positive_and_loop_scaled(self):
        L, M = 8, 64
        x, ws = torch.zeros(M, M), torch.zeros(L, M, M)

        def f():
            h = x
            for w in ws:
                h = h @ w
            return h
        cost = hlo_cost.analyze(f)
        lo = 2 * M * M * 4
        hi = 3 * L * (L * M * M * 4)
        assert lo < cost.hbm_bytes < hi
        assert cost.coll_bytes == 0 and cost.coll_by_op == {}


def test_sharded_product_counts_local_flops_only():
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(4, 4096), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            w = DTensor.from_local(torch.empty(256, 1024), mesh,
                                   [Shard(0), Shard(1)], run_check=False)
            assert tuple(x.shape) == (64, 4096)
            assert tuple(w.shape) == (4096, 16384)
            first = hlo_cost.analyze(lambda: x @ w)
            second = hlo_cost.analyze(lambda: x @ w)
    assert first.flops == second.flops == 33_554_432
    assert first.coll_by_op == second.coll_by_op
    assert first.coll_bytes > 0          # DTensor moves a factor first
