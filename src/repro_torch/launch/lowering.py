"""Shared lowering helpers, a port of the JAX reference's
``launch/lowering.py``: build the sharded train / prefill / decode step
for any (arch x shape x mesh) cell and trace one call of it on fake
stand-ins (no allocation) — the substrate of the dry-run and the
roofline analysis.

Where the reference ``jit``s the step with ``NamedSharding``s and
``.lower()``s it on ``ShapeDtypeStruct``s, the port places
``FakeTensor`` stand-ins of each rank's shard as ``DTensor``s on the
mesh (the placements of ``distributed.sharding``), runs the step once
under ``FakeTensorMode`` and counts rank 0's local work at the
dispatcher (``launch/hlo_cost.py``).  The mesh is a ``DeviceMesh`` on
the CPU over a fake process group (``fake_world``), so the stand-ins
are CPU tensors and the kernel wrappers take their plain versions: the
reference's dry-run likewise lowers for forced *host* devices, where
the SSD scan is jnp (``ssd_ops._use_pallas()`` is False) and attention
is jnp.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.logical import (P, local_shape_of,
                                             logical_axis_rules)
from repro_torch.launch import hlo_cost
from repro_torch.models import registry

# the paper's knob Q applied at the serving layer: MHA-width KV caches
# (kv_heads == n_heads) at decode_32k x batch 128 exceed HBM in bf16;
# fp8 KV (SS2.1, SageAttention2-style online quant) halves them.
FP8_KV_ARCHS = {"qwen1.5-32b"}

# sink+local windowed-KV adaptation (SS2.1) lowered as an EXTRA cell for
# pure full-attention archs at long_500k (the base cell stays skipped)
ADAPT_WINDOW = 61440
ADAPT_SINK = 4096


def cell_config(cfg: ModelConfig, shape: ShapeConfig, *,
                windowed_adaptation: bool = False) -> ModelConfig:
    if windowed_adaptation:
        cfg = cfg.with_window(ADAPT_WINDOW, ADAPT_SINK)
    if shape.kind == "decode" and cfg.name in FP8_KV_ARCHS:
        cfg = dataclasses.replace(cfg, kv_dtype="float8_e4m3fn")
    return cfg


# ---------------------------------------------------------------------------
# the fake world and the traced call
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of ``n`` ranks (this process is rank
    0; collectives return at once), destroyed on exit.  Refuses to
    replace a group that is already initialized."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class Lowered:
    """One traced call, per device: the counterpart of the reference's
    ``Lowered`` + ``Compiled`` pair as its analysis reads them."""
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_by_op: Dict[str, float]
    argument_bytes: int
    output_bytes: int
    heads_replicated: int


def _zip_map(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over the tensors of ``tree`` (dicts,
    tuples, named tuples, dataclasses; None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(*(_zip_map(fn, getattr(tree, f.name),
                                     getattr(other, f.name))
                            for f in dataclasses.fields(tree)))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, a, b) for a, b in zip(tree, other)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, a, b) for a, b in zip(tree, other))
    return fn(tree, other)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _stand_in(spec: torch.Tensor, sharding: shd.NamedSharding
              ) -> torch.Tensor:
    """A fake DTensor of ``spec``'s global shape and dtype whose local
    shard is rank 0's under ``sharding`` (call under FakeTensorMode)."""
    mesh, pl = sharding.mesh, sharding.placements
    shape = tuple(spec.shape)
    local_shape = local_shape_of(shape, mesh, pl)
    local = torch.empty(local_shape, dtype=spec.dtype,
                        device=mesh.device_type)
    return DTensor.from_local(
        local, mesh, pl, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def trace(fn: Callable, args: Any, shardings: Any, mesh) -> Lowered:
    """One call ``fn(*args)`` on fake stand-ins of ``args`` (a tuple of
    trees of meta tensors) laid out by ``shardings``; counts rank 0's
    work (``hlo_cost``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed.logical import per_shard
    per_shard.heads_replicated = 0
    with FakeTensorMode(allow_non_fake_inputs=True):
        placed = _zip_map(_stand_in, args, shardings)
        arg_bytes = sum(hlo_cost._bytes(t) for t in _leaves(placed))
        with hlo_cost.counting() as c:
            out = fn(*placed)
        out_bytes = sum(hlo_cost._bytes(t) for t in _leaves(out)
                        if isinstance(t, torch.Tensor))
    cost = c.cost()
    return Lowered(cost.flops, cost.hbm_bytes, cost.coll_bytes,
                   cost.coll_by_op, int(arg_bytes), int(out_bytes),
                   per_shard.heads_replicated)


# ---------------------------------------------------------------------------
# shardings of the serving state
# ---------------------------------------------------------------------------

def _path_leaf_map(fn: Callable, tree: Any, name: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _path_leaf_map(fn, v, str(k)) for k, v in tree.items()}
    return fn(name, tree)


def cache_shardings(cfg: ModelConfig, mesh, cache_spec: Any, *,
                    shard_seq: bool = False) -> Any:
    """Path-aware cache sharding: KV leaves [*,B,S,H,D] shard batch over
    data + heads over model (or sequence over data for long-context);
    SSM states shard heads/channels over model."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    b_ax: Any = batch_axes if not shard_seq else None
    s_ax: Any = batch_axes if shard_seq else None
    tp_size = shd.axis_sizes(mesh)[shd.TP]
    # KV heads shard over "model" only when divisible (GQA kv=8/16);
    # MHA-width or tiny-kv archs (40, 36, 4 heads) shard the cache
    # SEQUENCE over "model" instead.
    heads_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % tp_size == 0

    def spec(name, leaf):
        nd = len(leaf.shape)
        if name in ("k", "v"):                     # [L,B,S,H,D]
            if heads_ok:
                p = P(None, b_ax, s_ax, shd.TP, None)
            else:
                p = P(None, b_ax, shd.TP if not shard_seq else s_ax,
                      None, None)
        elif name in ("ck", "cv"):                 # [L,B,T_enc,H,D]
            p = P(None, b_ax, None, shd.TP if heads_ok else None, None)
        elif name == "ssm":                        # [L,B,H,P,N]
            p = P(None, b_ax, shd.TP, None, None)
        elif name == "conv":                       # [L,B,K-1,C]
            p = P(None, b_ax, None, shd.TP)
        else:
            p = P(*([None] * nd))
        assert len(p) <= nd, (name, nd)
        return shd.NamedSharding(mesh, p)

    return _path_leaf_map(spec, cache_spec)


def _batch_sharding(mesh, leaf, batch_axis: Any = "auto"
                    ) -> shd.NamedSharding:
    bp = shd.batch_pspec(mesh)
    b = (bp[0] if len(bp) else None) if batch_axis == "auto" else batch_axis
    return shd.NamedSharding(mesh, P(b, *((None,) * (len(leaf.shape) - 1))))


# ---------------------------------------------------------------------------
# the three steps
# ---------------------------------------------------------------------------

def lower_prefill(cfg: ModelConfig, mesh, shape: ShapeConfig) -> Lowered:
    api = registry.get_api(cfg)
    p_specs = registry.param_specs(cfg)
    p_shard = shd.param_shardings(p_specs, mesh, serve=True, ep=cfg.moe_ep)
    batch = registry.input_specs(cfg, shape)
    b_shard = {k: _batch_sharding(mesh, v) for k, v in batch.items()}
    rules = shd.serve_rules(mesh, ep=cfg.moe_ep)

    def fn(params, batch_in):
        with logical_axis_rules(mesh, rules):
            kw = {k: v for k, v in batch_in.items() if k != "tokens"}
            return api.prefill(cfg, params, batch_in["tokens"], **kw)

    return trace(fn, (p_specs, batch), (p_shard, b_shard), mesh)


def lower_decode(cfg: ModelConfig, mesh, shape: ShapeConfig) -> Lowered:
    api = registry.get_api(cfg)
    p_specs = registry.param_specs(cfg)
    p_shard = shd.param_shardings(p_specs, mesh, serve=True, ep=cfg.moe_ep)
    cache_spec = registry.cache_specs(cfg, shape)
    shard_seq = shape.global_batch == 1
    c_shard = cache_shardings(cfg, mesh, cache_spec, shard_seq=shard_seq)
    io = registry.input_specs(cfg, shape)        # token [B,1], pos [B]
    b_axis = None if shard_seq else "auto"
    tok_shard = _batch_sharding(mesh, io["token"], b_axis)
    pos_shard = _batch_sharding(mesh, io["pos"], b_axis)
    rules = shd.serve_rules(mesh, shard_seq=shard_seq, ep=cfg.moe_ep)

    def fn(params, cache, token, pos):
        with logical_axis_rules(mesh, rules):
            return api.decode_step(cfg, params, cache, token, pos)

    return trace(fn, (p_specs, cache_spec, io["token"], io["pos"]),
                 (p_shard, c_shard, tok_shard, pos_shard), mesh)


def lower_train(cfg: ModelConfig, mesh, shape: ShapeConfig, *,
                microbatches: int = 1) -> Lowered:
    from repro_torch.train.loop import lower_train_step
    return lower_train_step(cfg, mesh, shape, microbatches=microbatches)


def lower_cell(cfg: ModelConfig, mesh, shape: ShapeConfig, *,
               windowed_adaptation: bool = False,
               microbatches: int = 1) -> Lowered:
    cfg = cell_config(cfg, shape, windowed_adaptation=windowed_adaptation)
    if shape.kind == "train":
        return lower_train(cfg, mesh, shape, microbatches=microbatches)
    if shape.kind == "prefill":
        return lower_prefill(cfg, mesh, shape)
    return lower_decode(cfg, mesh, shape)
