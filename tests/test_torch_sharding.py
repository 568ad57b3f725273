"""The port's sharding rules (``repro_torch.distributed.{logical,
sharding}``, ``launch/mesh.py``) against the JAX reference's.

* ``param_pspec`` over every config's full-size param tree (meta
  stand-ins on the port's side, ``jax.eval_shape`` on the reference's):
  the same leaf paths, and the same spec leaf by leaf, in the train,
  serve, ``ep`` and ``zero3`` variants.
* The reference's ``tests/test_sharding.py::{TestParamRules,
  TestLogicalRules}`` on the port, and the logical rules the models
  annotate with: ``shard`` is a no-op outside a mesh and checks ranks
  inside one.
* ``placements`` on a 2x2 gloo mesh (4 spawned ranks): each rank's
  local shard of ``arange`` equals the block JAX's ``NamedSharding``
  gives the device at the same mesh coordinate (4 forced host devices
  in a subprocess).
* The per-device parameter bytes at pod16x16 for minicpm-2b and
  minitron-8b: the shard shapes DTensor gives rank 0 on a fake
  256-rank (16, 16) mesh equal the reference's
  ``NamedSharding(AbstractMesh, spec).shard_shape``, leaf by leaf.

Spawned ranks meet through ``init_method="file://<tmp_path>/..."`` (no
port) and are joined with a deadline of their own (``_SPAWN_TIMEOUT``).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs.base import get_config as jax_get_config
from repro.distributed import sharding as jshd
from repro.models import registry as JR
from repro_torch.configs.base import get_config, list_archs
from repro_torch.distributed import logical, sharding as shd
from repro_torch.distributed.logical import P, resolve_spec
from repro_torch.launch.lowering import fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(list_archs())
VARIANTS = {"train": {}, "serve": {"serve": True}, "ep": {"ep": True},
            "zero3": {"layout": "zero3"}}
_SPAWN_TIMEOUT = 120


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], path + (k,))
    else:
        yield path, tree


_JAX_SPECS = {}


def _jax_leaves(arch):
    if arch not in _JAX_SPECS:
        spec = JR.param_specs(jax_get_config(arch))
        _JAX_SPECS[arch] = {
            tuple(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(spec)[0]}
    return _JAX_SPECS[arch]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_matches_reference(arch, variant):
    kw = VARIANTS[variant]
    want = _jax_leaves(arch)
    got = dict(_port_leaves(registry.param_specs(get_config(arch))))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        ndim = len(leaf.shape)
        assert ndim == len(want[path].shape), path
        assert tuple(shd.param_pspec(path, ndim, **kw)) == \
            tuple(jshd.param_pspec(path, ndim, **kw)), (path, variant)


# ---------------------------------------------------------------------------
# the reference's TestParamRules / TestLogicalRules
# ---------------------------------------------------------------------------

class TestParamRules:
    def test_rank_padding_for_stacked_layers(self):
        assert shd.param_pspec(("layers", "mlp", "w_gate"), 3) == \
            P(None, "data", "model")
        assert shd.param_pspec(("layers", "attn", "wo"), 3) == \
            P(None, "model", "data")

    def test_serve_rules_drop_fsdp(self):
        assert shd.param_pspec(("layers", "attn", "wq"), 3, serve=True) == \
            P(None, None, "model")

    def test_unknown_params_replicated(self):
        assert shd.param_pspec(("final_norm",), 1) == P(None)

    def test_vocab_padding_divisible(self):
        for arch in ("minicpm-2b", "whisper-medium", "mamba2-780m",
                     "granite-moe-1b-a400m", "internvl2-26b"):
            cfg = get_config(arch)
            assert cfg.padded_vocab % 256 == 0
            assert cfg.padded_vocab >= cfg.vocab_size


class TestLogicalRules:
    def test_duplicate_mesh_axis_dropped(self):
        spec = resolve_spec(["batch", None, "heads"],
                            {"batch": ("data",), "heads": ("data",)})
        assert spec == P("data", None, None)

    def test_multi_axis_batch(self):
        spec = resolve_spec(["batch", None],
                            {"batch": ("pod", "data")})
        assert spec == P(("pod", "data"), None)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_activation_rules_match_reference(multi_pod):
    """``train_rules`` / ``serve_rules`` / ``batch_pspec`` /
    ``cache_pspec`` over the production meshes' axis names (the rules
    read only the names)."""
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    jmesh = AbstractMesh(sizes, names)

    class _Mesh:                       # the names are all the rules read
        mesh_dim_names = names

    for kw in ({}, {"ep": True}, {"layout": "zero3"}):
        assert shd.train_rules(_Mesh, **kw) == jshd.train_rules(jmesh, **kw)
    for kw in ({}, {"shard_seq": True}, {"ep": True}):
        assert shd.serve_rules(_Mesh, **kw) == jshd.serve_rules(jmesh, **kw)
    for layout in ("tp_fsdp", "zero3"):
        assert tuple(shd.batch_pspec(_Mesh, layout)) == \
            tuple(jshd.batch_pspec(jmesh, layout))
    for nd in (2, 3, 4, 5):
        for seq in (False, True):
            assert tuple(shd.cache_pspec(_Mesh, nd, shard_seq=seq)) == \
                tuple(jshd.cache_pspec(jmesh, nd, shard_seq=seq))


def test_shard_is_a_no_op_outside_a_mesh_and_checks_rank_inside():
    x = torch.ones(2, 3)
    assert logical.shard(x, "batch", None, "embed") is x     # no mesh
    assert logical.current() is None
    with logical.logical_axis_rules(object(), {"batch": "data"}):
        assert logical.shard(x, "batch", None) is x          # plain tensor
        with pytest.raises(ValueError, match="rank-2"):
            logical.shard(x, "batch", None, "embed")
    assert logical.current() is None


def test_placements_follow_mesh_order():
    class _Mesh:
        mesh_dim_names = ("pod", "data", "model")

    from torch.distributed.tensor import Replicate, Shard
    assert logical.placements(P(("pod", "data"), None, "model"), _Mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert logical.placements(P(None, "data"), _Mesh) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        logical.placements(P(("data", "pod"),), _Mesh)


# ---------------------------------------------------------------------------
# local shards on a 2x2 gloo mesh against JAX's NamedSharding
# ---------------------------------------------------------------------------

SHAPE = (8, 6, 4)
SPECS = [(None, None, None), ("data", None, None), (None, "model", None),
         ("data", "model", None), ("model", None, "data"),
         (("data", "model"), None, None), (None, None, "model")]

_JAX_BLOCKS = """
import json, jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for i, spec in enumerate(json.loads(SPECS)):
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(SHAPE)
    blocks = {}
    for r in range(2):
        for c in range(2):
            d = mesh.devices[r, c]
            blocks[f"{r},{c}"] = [[s.start or 0, s.stop if s.stop is not None
                                   else n] for s, n in zip(idx[d], SHAPE)]
    out[i] = blocks
print("BLOCKS", json.dumps(out))
"""


def _jax_blocks():
    code = _JAX_BLOCKS.replace("SPECS", repr(json.dumps(SPECS))).replace(
        "SHAPE)", f"{SHAPE})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                         capture_output=True, text=True, check=True).stdout
    line = next(x for x in out.splitlines() if x.startswith("BLOCKS "))
    return json.loads(line[len("BLOCKS "):])


def _local_shards(rank, world, init, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        full = torch.arange(int(np.prod(SHAPE))).reshape(SHAPE)
        got = []
        for spec in SPECS:
            pl = logical.placements(P(*spec), mesh)
            got.append(distribute_tensor(full, mesh, pl).to_local().tolist())
        coord = mesh.get_coordinate()
        with open(f"{out}.{rank}", "w") as f:
            json.dump({"coord": coord, "local": got}, f)
    finally:
        dist.destroy_process_group()


def run_spawned(fn, world, tmp_path, *args):
    """Spawn ``world`` ranks of ``fn(rank, world, init, *args)`` meeting
    through a file under ``tmp_path``; fail (and kill them) past
    ``_SPAWN_TIMEOUT`` seconds."""
    init = f"file://{tmp_path}/pg"
    ctx = mp.start_processes(fn, args=(world, init) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.time() + _SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.time())):
            if time.time() > deadline:
                raise TimeoutError(f"spawned ranks still running after "
                                   f"{_SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def test_placements_give_jax_local_shards(tmp_path):
    want = _jax_blocks()
    out = str(tmp_path / "local")
    run_spawned(_local_shards, 4, tmp_path, out)
    full = np.arange(int(np.prod(SHAPE))).reshape(SHAPE)
    for rank in range(4):
        with open(f"{out}.{rank}") as f:
            got = json.load(f)
        r, c = got["coord"]
        for i, local in enumerate(got["local"]):
            blk = want[str(i)][f"{r},{c}"]
            ref = full[tuple(slice(a, b) for a, b in blk)]
            np.testing.assert_array_equal(np.array(local), ref,
                                          err_msg=str(SPECS[i]))


# ---------------------------------------------------------------------------
# per-device parameter bytes at pod16x16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minicpm-2b", "minitron-8b"])
def test_per_device_param_bytes_at_pod16x16(arch):
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    want = {}
    for path, leaf in _jax_leaves(arch).items():
        spec = jshd.param_pspec(path, len(leaf.shape))
        shp = NamedSharding(jmesh, spec).shard_shape(leaf.shape)
        want[path] = (tuple(shp), leaf.dtype.itemsize)
    specs = dict(_port_leaves(registry.param_specs(get_config(arch))))
    total = 0
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        for path, leaf in specs.items():
            sh = shd.NamedSharding(mesh, shd.param_pspec(path,
                                                         len(leaf.shape)))
            local = logical.local_shape_of(tuple(leaf.shape), mesh,
                                           sh.placements)
            assert (tuple(local), leaf.element_size()) == want[path], path
            total += int(np.prod(local)) * leaf.element_size()
    assert total == sum(int(np.prod(s)) * b for s, b in want.values())


@pytest.mark.parametrize("mesh_shape,shape,pl", [
    ((2, 2), (5, 7), ("S0", "S1")),
    ((16, 16), (122753, 2304), ("S1", "S0")),
    ((16, 16), (36, 40), ("S0", "S0")),          # one dim over both
    ((2, 16, 16), (3, 100, 9), ("S1", "S1", "R")),
    ((4, 3), (10,), ("R", "S0")),
])
def test_local_box_is_dtensors_block(mesh_shape, shape, pl):
    """``logical.local_box`` (offset, size) at every mesh coordinate is
    the block DTensor assigns there, uneven and empty blocks included."""
    from types import SimpleNamespace
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    placements = [Replicate() if p == "R" else Shard(int(p[1]))
                  for p in pl]
    mesh = SimpleNamespace(shape=mesh_shape)
    for coord in np.ndindex(*mesh_shape):
        size, off = _compute_local_shape_and_global_offset(
            shape, mesh_shape, list(coord), placements)
        got_off, got_size = logical.local_box(shape, mesh, placements,
                                              coord)
        assert got_size == tuple(size), (coord, got_size, size)
        if all(size):                   # (an empty block's offset is moot)
            assert got_off == tuple(off), (coord, got_off, off)
