"""Checkpoints of the port (``repro_torch.train.checkpoint``) on the CPU:
the reference's ``tests/test_train.py::TestCheckpoint`` on the port
(round trip and ``latest_step``, the async save, resume bit for bit
inside torch; ``test_elastic_resharding_restore`` as a restore onto a
1x1 mesh), a bf16 leaf restored bit for bit
through its uint16 bits, and the on-disk format shared with the
reference: a reduced fp32 checkpoint written by the reference restores
in the port bit for bit, and one written by the port restores in the
reference.
"""
import json
import os

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import registry as JR
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data import pipeline as dp
from repro_torch.models import registry
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop, optimizer as opt

pytestmark = pytest.mark.slow

torch.set_num_threads(2)


def _small_state(arch="minicpm-2b", dtype=None):
    cfg = get_config(arch).reduced()
    params = registry.get_api(cfg).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    if dtype is not None:
        params = opt.tree_map(lambda t: t.to(dtype), params)
    return cfg, loop.TrainState(params, opt.init_opt_state(params))


def _leaves(state):
    return [t for _, t in ckpt._flatten_with_names(state)]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip_and_latest(tmp_path):
    _, state = _small_state()
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    ckpt.save(d, 7, state)
    ckpt.save(d, 12, state)
    assert ckpt.latest_step(d) == 12
    _assert_same(state, ckpt.restore(d, 12, state))


def test_async_save(tmp_path):
    _, state = _small_state()
    t = ckpt.save(str(tmp_path), 3, state, blocking=False)
    t.join()
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_async_save_copies_at_call_time(tmp_path):
    """The state is copied to the host when ``save`` is called: updating
    it in place afterwards (as the train step does) leaves the written
    checkpoint as it was."""
    _, state = _small_state()
    want = [t.clone() for t in _leaves(state)]
    t = ckpt.save(str(tmp_path), 1, state, blocking=False)
    with torch.no_grad():
        for leaf in _leaves(state):
            leaf.add_(1)
    t.join()
    got = _leaves(ckpt.restore(str(tmp_path), 1, state))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_restore_under_shardings_waits(tmp_path):
    """``restore(shardings=)`` no longer waits: on a 1x1 mesh of a
    one-rank gloo group each leaf comes back a DTensor laid out by
    ``loop.state_shardings``, equal to the saved leaf bit for bit (the
    4-rank resharding: ``tests/test_torch_dist_train.py``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    cfg, state = _small_state()
    ckpt.save(str(tmp_path), 1, state)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        got = ckpt.restore(str(tmp_path), 1, state,
                           shardings=loop.state_shardings(cfg, mesh))
        for a, b in zip(_leaves(got), _leaves(state)):
            assert isinstance(a, DTensor)
            assert torch.equal(a.full_tensor(), b)
    finally:
        dist.destroy_process_group()


class _LargestTensor:
    """The most bytes of any plain tensor an aten op returns inside it
    (a DTensor op is counted by its local ops; a meta tensor, which
    holds no memory, is not counted)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_flatten
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                for t in tree_flatten(out)[0]:
                    if isinstance(t, torch.Tensor) and not t.is_meta:
                        outer.most = max(outer.most,
                                         t.numel() * t.element_size())
                return out
        self.most = 0
        self.mode = Mode()


def test_sharded_leaf_is_never_whole_on_one_rank(tmp_path):
    """A 32 MiB leaf laid out over a (16, 16) mesh of a fake 256-rank
    group, of which rank 0 holds one 128 KiB block: ``restore(shardings=)``
    reads only that block from the file (numpy's host allocations, which
    tracemalloc traces, and every tensor an aten op returns stay under 4
    blocks) and it equals that block of the file; ``save`` of the
    restored DTensor gathers into the file one block at a time under the
    same bound, rank 0's block landing where it was."""
    import tracemalloc
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.logical import P
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.lowering import fake_world
    shape, block = (4096, 2048), 256 * 128 * 4
    (tmp_path / "step_1").mkdir()
    arr = np.lib.format.open_memmap(str(tmp_path / "step_1" / "00000.npy"),
                                    mode="w+", dtype=np.float32,
                                    shape=shape)
    for r in range(0, shape[0], 256):
        arr[r:r + 256] = np.arange(r * shape[1], (r + 256) * shape[1],
                                   dtype=np.float32).reshape(256, -1)
    arr.flush()
    del arr
    with open(tmp_path / "step_1" / "index.json", "w") as f:
        json.dump({"step": 1, "leaves": [{
            "name": "leaf", "file": "00000.npy", "shape": list(shape),
            "dtype": "float32"}]}, f)
    want = torch.from_numpy(np.load(str(tmp_path / "step_1" / "00000.npy"),
                                    mmap_mode="r")[:256, :128].copy())
    like = torch.empty(shape, device="meta")
    with fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        sh = NamedSharding(mesh, P("model", "data"))
        big = _LargestTensor()
        tracemalloc.start()
        try:
            with big.mode:
                got = ckpt.restore(str(tmp_path), 1, like, shardings=sh)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert isinstance(got, DTensor) and tuple(got.shape) == shape
        assert torch.equal(got.to_local(), want)
        assert peak < 4 * block and big.most < 4 * block, (peak, big.most)

        big = _LargestTensor()
        tracemalloc.start()
        try:
            with big.mode:
                ckpt.save(str(tmp_path), 2, got)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert peak < 4 * block and big.most < 4 * block, (peak, big.most)
    back = np.load(str(tmp_path / "step_2" / "00000.npy"), mmap_mode="r")
    assert back.shape == shape
    assert torch.equal(torch.from_numpy(back[:256, :128].copy()), want)


def test_shape_mismatch_raises(tmp_path):
    _, state = _small_state()
    ckpt.save(str(tmp_path), 1, state)
    other = loop.TrainState(dict(state.params), state.opt_state)
    other.params["final_norm"] = torch.ones(3)
    with pytest.raises(ValueError, match="final_norm"):
        ckpt.restore(str(tmp_path), 1, other)


def test_bf16_leaves_restore_bit_for_bit(tmp_path):
    """bf16 params are stored as their uint16 bits, "bfloat16" in the
    index, and restored bit for bit (NaN and -0.0 included)."""
    _, state = _small_state(dtype=torch.bfloat16)
    w = state.params["final_norm"]
    w[0] = float("nan")
    w[1] = -0.0
    w[2] = 1.0 + 2.0 ** -7
    ckpt.save(str(tmp_path), 4, state)
    with open(os.path.join(tmp_path, "step_4", "index.json")) as f:
        index = json.load(f)
    dtypes = {e["name"]: e["dtype"] for e in index["leaves"]}
    assert dtypes["0__final_norm"] == "bfloat16"
    assert dtypes["1__.m__final_norm"] == "float32"
    assert dtypes["1__.step"] == "int32"
    back = ckpt.restore(str(tmp_path), 4, state)
    for a, b in zip(_leaves(state), _leaves(back)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_resume_is_bitwise(tmp_path):
    """Kill/restart equivalence: steps k..n from a checkpoint equal an
    uninterrupted run (same data, same state), bit for bit."""
    cfg, state = _small_state()
    shape = ShapeConfig("t", "train", 16, 4)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = loop.make_train_step(cfg, ocfg)

    def clone(s):
        return ckpt._rebuild(s, {n: t.clone() for n, t in
                                 ckpt._flatten_with_names(s)})

    def run(state, lo, hi):
        for s in range(lo, hi):
            state, _ = step(state, dp.global_batch(cfg, shape, s))
        return state

    full = run(clone(state), 0, 4)
    mid = run(clone(state), 0, 2)
    ckpt.save(str(tmp_path), 2, mid)
    resumed = ckpt.restore(str(tmp_path), 2, clone(state))
    part = run(resumed, 2, 4)
    _assert_same(full, part)


def _jax_state():
    jcfg = jax_get_config("minicpm-2b").reduced()
    params = JR.init_fn(jcfg)(jax.random.PRNGKey(0))
    return jloop.TrainState(params, jopt.init_opt_state(params))


def test_restores_a_reference_checkpoint(tmp_path):
    """A reduced fp32 checkpoint written by the reference (after one
    optimizer update, so the moments and step are not zero) restores in
    the port bit for bit, leaf by leaf under the same names."""
    js = _jax_state()
    g = jax.tree_util.tree_map(lambda p: p * 0.5 + 0.01, js.params)
    p2, st2, _ = jopt.adamw_update(jopt.OptConfig(), js.params, g,
                                   js.opt_state)
    js = jloop.TrainState(p2, st2)
    jckpt.save(str(tmp_path), 1, js)
    _, like = _small_state()
    got = ckpt.restore(str(tmp_path), 1, like)
    want = dict(jckpt._flatten_with_names(js)[0])
    names = [n for n, _ in ckpt._flatten_with_names(got)]
    assert sorted(names) == sorted(want)
    for name, t in ckpt._flatten_with_names(got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]),
                                      err_msg=name)
    assert int(got.opt_state.step) == 1


def test_reference_restores_a_port_checkpoint(tmp_path):
    _, state = _small_state()
    ckpt.save(str(tmp_path), 5, state)
    js = _jax_state()
    back = jckpt.restore(str(tmp_path), 5, js)
    want = {n: t.numpy() for n, t in ckpt._flatten_with_names(state)}
    for name, leaf in jckpt._flatten_with_names(back)[0]:
        np.testing.assert_array_equal(np.asarray(leaf), want[name],
                                      err_msg=name)


def test_leaf_names_are_the_references():
    """Every leaf name of a port state is the reference's name of the
    same leaf (``TrainState`` children 0 / 1, ``OptState`` fields,
    sorted dict keys, joined by ``__``), in the same order."""
    _, state = _small_state()
    port = [n for n, _ in ckpt._flatten_with_names(state)]
    ref = [n for n, _ in jckpt._flatten_with_names(_jax_state())[0]]
    assert port == ref
    p = params_from_numpy({"a": np.zeros(2, np.float32)})
    assert [n for n, _ in ckpt._flatten_with_names(p)] == ["a"]
