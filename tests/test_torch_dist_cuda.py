"""Sharded steps on NCCL across cards: the job of
``tests/test_torch_dist_train.py`` (two reduced fp32 train steps, then
the gradients, sharded against unsharded; prefill and 4 decode steps)
on a 1x2 and a 2x2 (data, model) mesh, one rank per card, each held
within 1e-5 of the same steps on its own card; and a one-rank
checkpoint restored onto the mesh and saved from it (the blocks sent to
rank 0 over NCCL), both bit for bit.  The SSD families are
left out of training: the SSD kernel has no backward on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU, or with fewer
cards than its mesh needs.  This file imports no JAX::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_dist_cuda.py
"""
import pytest
import torch

from test_torch_dist_train import (SERVE_ARCHS, check, one_rank_checkpoint,
                                   run_job)

pytestmark = pytest.mark.cuda

CARD_TRAIN_ARCHS = ["minitron-8b", "minicpm-2b", "granite-moe-1b-a400m",
                    "internvl2-26b", "whisper-medium", "ardit-self-forcing"]


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.device_count()


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_sharded_steps_on_nccl_within_1e5(mesh_shape, cards, tmp_path):
    n = mesh_shape[0] * mesh_shape[1]
    if cards < n:
        pytest.skip(f"needs {n} NVIDIA GPUs")
    res = run_job(tmp_path, n, "nccl", "cuda", mesh_shape, CARD_TRAIN_ARCHS,
                  SERVE_ARCHS, one_rank_checkpoint(str(tmp_path / "ckpt")))
    for arch in CARD_TRAIN_ARCHS:
        r = check(res, f"train/{arch}")
        for a, b in zip(r["loss0"], r["loss1"]):
            assert abs(a - b) <= 1e-5, (arch, r["loss0"], r["loss1"])
        assert max(r["params"], r["m"], r["v"]) <= 1e-5, (arch, r)
        assert r["grads_rel"] <= 1e-5 and r["step"], (arch, r)
        print(f"{mesh_shape} {arch}: losses {r['loss0']} / {r['loss1']}, "
              f"params {r['params']:.3g}, gradients {r['grads_rel']:.3g}")
    for arch in SERVE_ARCHS:
        r = check(res, f"serve/{arch}")
        assert max(r["logits"]) <= 1e-5 and r["cache"] <= 1e-5, (arch, r)
        print(f"{mesh_shape} {arch}: logits {max(r['logits']):.3g}, cache "
              f"{r['cache']:.3g}")
    r = check(res, "restore/minicpm-2b")
    assert r["restore"] and r["save"], r
