"""Parameter / activation sharding rules for the production meshes, a
port of the JAX reference's ``distributed/sharding.py`` (the rule
tables are the reference's, copied).

Meshes (launch/mesh.py): single-pod ``(data=16, model=16)`` = 256 chips;
multi-pod ``(pod=2, data=16, model=16)`` = 512 chips.

Training layout (DESIGN.md SS5):
    TP   ("model"): attention heads / FFN hidden / vocab sharded
    FSDP ("data"):  the non-TP dim of every large weight sharded; XLA
                    all-gathers per layer inside the scan (prefetchable)
    DP   ("pod" x "data"): batch; cross-pod traffic is gradient-only
Optimizer state follows the parameter layout (ZeRO: sharded over both
mesh axes; nothing is replicated but small vectors).

Serving layout: weights replicated over "data" (gathers would sit on the
decode critical path), TP over "model"; the KV cache shards batch over
"data" and KV heads over "model"; ``long_500k`` (batch=1) shards the
cache SEQUENCE over "data" instead.

Rules are name-based (t5x-style): the LAST path component of each param
selects a spec for its trailing dims; stacked-layer leading dims (scan)
get None.

A "sharding" here is ``NamedSharding(mesh, spec)``: the reference's
record, whose ``placements`` are the ``DTensor`` placements of
``logical.placements``.  ``distribute`` places a tree of tensors by a
tree of them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.logical import PartitionSpec as P
from repro_torch.distributed.logical import placements as _placements

FSDP = "data"
TP = "model"

# trailing-dims spec per parameter name; leading (stacked/scan) dims -> None
_TRAIN_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # transformer attention
    "wq": (FSDP, TP), "wk": (FSDP, TP), "wv": (FSDP, TP), "wo": (TP, FSDP),
    "bq": (TP,), "bk": (TP,), "bv": (TP,),
    # dense MLP
    "w_gate": (FSDP, TP), "w_up": (FSDP, TP), "w_down": (TP, FSDP),
    "wi": (FSDP, TP),
    # MoE (expert-TP: expert hidden over TP, expert dim unsharded)
    "router": (FSDP, None),
    "we_gate": (None, FSDP, TP), "we_up": (None, FSDP, TP),
    "we_down": (None, TP, FSDP),
    # embeddings / heads
    "embed": (TP, FSDP), "lm_head": (FSDP, TP),
    # mamba
    "wz": (FSDP, TP), "wx": (FSDP, TP),
    "wB": (FSDP, None), "wC": (FSDP, None), "wdt": (FSDP, None),
    "out": (TP, FSDP), "conv_w": (TP, None), "conv_b": (TP,),
    "A_log": (None,), "D": (None,), "dt_bias": (None,), "norm_w": (TP,),
    # AR-DiT
    "in_proj": (None, TP), "cond_proj": (FSDP, TP),
    "t_mlp1": (None, TP), "t_mlp2": (TP, FSDP),
    "mod": (FSDP, TP), "mod_b": (None,),
    "final_mod": (FSDP, TP), "out_proj": (TP, None),
}

_SERVE_OVERRIDES = {k: tuple(None if a == FSDP else a for a in v)
                    for k, v in _TRAIN_PARAM_RULES.items()}

# EP variant: expert dim over "model", expert hidden unsharded
_EP_RULES = {
    "we_gate": (TP, FSDP, None), "we_up": (TP, FSDP, None),
    "we_down": (TP, None, FSDP),
}
_EP_SERVE_RULES = {k: tuple(None if a == FSDP else a for a in v)
                   for k, v in _EP_RULES.items()}


ALL = ("data", "model")        # combined 256-way axis for the zero3 layout


def param_pspec(path: Sequence[str], ndim: int, *,
                serve: bool = False, ep: bool = False,
                layout: str = "tp_fsdp") -> P:
    rules = _SERVE_OVERRIDES if serve else _TRAIN_PARAM_RULES
    name = path[-1]
    spec = rules.get(name)
    if ep and name in _EP_RULES:
        spec = (_EP_SERVE_RULES if serve else _EP_RULES)[name]
    if spec is None:
        spec = (None,) * ndim                  # norms & misc: replicated
    if layout == "zero3" and not serve:
        # ZeRO-3: no tensor parallelism — shard the first previously-
        # sharded dim of each weight over BOTH axes (256-way), rest
        # replicated; XLA all-gathers each layer's weights on use.
        first = next((i for i, a in enumerate(spec) if a is not None),
                     None)
        spec = tuple(ALL if i == first else None
                     for i in range(len(spec)))
    assert len(spec) <= ndim, (path, ndim, spec)
    return P(*((None,) * (ndim - len(spec)) + tuple(spec)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on a mesh: the reference's
    ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> Tuple:
        return _placements(self.spec, self.mesh)


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(param_tree: Any, mesh, *, serve: bool = False,
                    ep: bool = False, layout: str = "tp_fsdp") -> Any:
    """NamedSharding tree matching ``param_tree`` (nested dicts of
    tensors, meta stand-ins included); the path names are the dict
    keys, as the reference forms them."""
    return _tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_pspec(
            path, len(leaf.shape), serve=serve, ep=ep, layout=layout)),
        param_tree)


def distribute(tree: Any, shardings: Any) -> Any:
    """Each tensor of ``tree`` as a DTensor laid out by the matching
    NamedSharding of ``shardings`` (rank 0's values; every rank must
    call it)."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Tensor):
        return type(tree)(distribute(v, s) for v, s in zip(tree, shardings))
    return distribute_tensor(tree, shardings.mesh, shardings.placements)


# ---------------------------------------------------------------------------
# activation logical-axis rules (consumed by distributed.logical.shard)
# ---------------------------------------------------------------------------

def train_rules(mesh, *, ep: bool = False,
                layout: str = "tp_fsdp") -> Dict[str, Any]:
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    if layout == "zero3":
        # batch over EVERY mesh axis; no tensor-parallel activation axes
        batch_axes = tuple(a for a in ("pod", "data", "model")
                           if a in mesh.mesh_dim_names)
        return {"batch": batch_axes, "heads": None, "kv_heads": None,
                "ff": None, "inner": None, "experts": None,
                "expert_ff": None, "vocab": None, "embed": None,
                "seq_sp": None, "seq_kv": None}
    return {
        "batch": batch_axes,
        "heads": TP, "kv_heads": TP,
        "ff": TP, "inner": TP,
        "experts": TP if ep else None,
        "expert_ff": None if ep else TP,
        "vocab": TP,
        "embed": None, "seq_sp": None, "seq_kv": None,
    }


def serve_rules(mesh, *, shard_seq: bool = False,
                ep: bool = False) -> Dict[str, Any]:
    """``shard_seq``: long-context decode (batch=1) — KV sequence over
    "data" gives the flash-decoding partial-softmax combine."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return {
        "batch": None if shard_seq else batch_axes,
        "heads": TP, "kv_heads": TP,
        "ff": TP, "inner": TP,
        "experts": TP if ep else None,
        "expert_ff": None if ep else TP,
        "vocab": TP,
        "embed": None, "seq_sp": None,
        "seq_kv": batch_axes if shard_seq else None,
    }


def batch_pspec(mesh, layout: str = "tp_fsdp") -> P:
    names = ("pod", "data", "model") if layout == "zero3" else \
        ("pod", "data")
    batch_axes = tuple(a for a in names if a in mesh.mesh_dim_names)
    return P(batch_axes)


def cache_pspec(mesh, cache_leaf_ndim: int, *,
                shard_seq: bool = False) -> P:
    """Decode-cache sharding: [L, B, S, H, D]-shaped leaves (or SSM/conv
    state shapes).  Batch over data (or seq over data for long-context),
    KV heads over model where the rank allows."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    if cache_leaf_ndim == 5:     # [L,B,S,H,D] attention KV
        if shard_seq:
            return P(None, None, batch_axes, TP, None)
        return P(None, batch_axes, None, TP, None)
    if cache_leaf_ndim == 4:     # [L,B,*,*] ssm conv state etc.
        return P(None, batch_axes, None, None)
    if cache_leaf_ndim == 3:
        return P(None, batch_axes, None)
    return P(*([None] * cache_leaf_ndim))
