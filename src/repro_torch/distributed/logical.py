"""Logical-axis sharding, a port of the JAX reference's
``distributed/logical.py``: models annotate tensors with *logical* axis
names; a rules table maps logical names to mesh axes.  Outside a mesh
context the annotations are no-ops, so the same model code runs on one
device and on a (16, 16) mesh.

Under ``logical_axis_rules(mesh, rules)`` the parameters and the batch
are ``DTensor``s on a ``DeviceMesh`` whose dims are named as the
reference's mesh axes (``launch/mesh.py``).  ``shard(x, *axes)``
redistributes a DTensor to the placements its logical axes resolve to:
the port's ``with_sharding_constraint``.  A plain tensor that meets a
DTensor inside the context is treated as replicated
(DTensor's implicit replication), as an unannotated constant is under
GSPMD.

The reference's ``PartitionSpec`` is a tuple here (``PartitionSpec``):
one entry per tensor dim, each ``None``, a mesh-axis name or a tuple of
names.  ``placements(spec, mesh)`` turns it into one placement per mesh
dim: a tensor dim over ``("pod", "data")`` is ``Shard(d)`` on both mesh
dims, in mesh order, which is JAX's major-to-minor order of the axes in
a spec entry (``tests/test_torch_sharding.py`` shows the local shards
equal).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

MeshAxis = Union[None, str, Tuple[str, ...]]

TP = "model"
BATCH_AXES = ("pod", "data")

_STATE = threading.local()


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec``: a tuple of
    per-dim entries (``None``, an axis name or a tuple of names),
    normalized as JAX does (a one-name tuple is the name, an empty one
    None)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def current():
    """The active ``(mesh, rules)``, or None outside a mesh context."""
    return getattr(_STATE, "env", None)


@contextlib.contextmanager
def use_env(env):
    """Re-enter an environment taken with ``current()`` (None: none),
    e.g. in a recomputation that runs on another thread."""
    prev = current()
    disp = DTensor._op_dispatcher
    prev_implicit = disp._allow_implicit_replication
    _STATE.env = env
    # (``implicit_replication()`` resets the flag to False on exit, which
    # would end it for an enclosing context: save and restore it here)
    disp._allow_implicit_replication = env is not None or prev_implicit
    try:
        yield
    finally:
        _STATE.env = prev
        disp._allow_implicit_replication = prev_implicit


def logical_axis_rules(mesh, rules: Dict[str, MeshAxis]):
    """Activate a mesh + logical->mesh axis mapping for the model code
    (and implicit replication of plain tensors meeting DTensors)."""
    return use_env((mesh, dict(rules)))


def resolve_spec(axes: Sequence[Optional[str]],
                 rules: Dict[str, MeshAxis]) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec, dropping duplicate mesh
    axes (a mesh axis may shard at most one tensor dimension)."""
    used = set()
    out = []
    for name in axes:
        mesh_axes = rules.get(name) if name is not None else None
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        kept = tuple(a for a in mesh_axes if a not in used)
        used.update(kept)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(kept)
    return PartitionSpec(*out)


def placements(spec: Sequence[MeshAxis], mesh) -> Tuple:
    """One placement per mesh dim for a tensor laid out by ``spec``: a
    mesh axis that shards tensor dim ``d`` is ``Shard(d)``, any other
    ``Replicate()``.  Axes of one spec entry must come in mesh order
    (major to minor); an axis the mesh lacks is ignored."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Constrain ``x`` to its logical axes: a DTensor is redistributed
    to the resolved placements; a no-op without an active mesh or for a
    plain tensor."""
    env = current()
    if env is None:
        return x
    mesh, rules = env
    if len(axes) != x.ndim:
        raise ValueError(f"shard(): {len(axes)} axes for rank-{x.ndim} "
                         f"array")
    if not isinstance(x, DTensor):
        return x
    want = placements(resolve_spec(axes, rules), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def local_box(shape: Sequence[int], mesh, pl: Sequence,
              coord: Optional[Sequence[int]] = None) -> Tuple[Tuple, Tuple]:
    """(offset, size) per dim of the block of a ``shape`` tensor laid
    out by ``pl`` on ``mesh`` that the rank at mesh coordinate ``coord``
    (default: this rank's) holds.  Each ``Shard(d)`` in mesh order
    splits dim ``d``'s current block into chunks of ``ceil(n / size)``,
    as ``torch.chunk`` and DTensor do (pure Python, so it also runs
    under ``FakeTensorMode``)."""
    off, out = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate() if coord is None else coord
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n, k = out[p.dim], mesh.shape[i]
            chunk = -(-n // k)
            start = min(coord[i] * chunk, n)
            off[p.dim] += start
            out[p.dim] = min(chunk, n - start)
    return tuple(off), tuple(out)


def local_shape_of(shape: Sequence[int], mesh, pl: Sequence) -> Tuple:
    """This rank's shard shape of a ``shape`` tensor laid out by ``pl``
    on ``mesh`` (``local_box``'s size)."""
    return local_box(shape, mesh, pl)[1]


def as_dtensor(x: torch.Tensor, mesh) -> DTensor:
    """``x`` as a DTensor on ``mesh``: a plain tensor is taken as
    replicated (as implicit replication takes it)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def empty(shape, dtype, like: torch.Tensor,
          axes: Sequence[Optional[str]]) -> torch.Tensor:
    """``torch.empty(shape)`` on ``like``'s device; under a mesh, when
    ``like`` is a DTensor, a DTensor laid out by the logical ``axes``
    (each rank allocates its own shard)."""
    env = current()
    if env is None or not isinstance(like, DTensor):
        return torch.empty(shape, dtype=dtype, device=like.device)
    mesh, rules = env
    pl = placements(resolve_spec(axes, rules), mesh)
    local_shape = local_shape_of(shape, mesh, pl)
    local = torch.empty(local_shape, dtype=dtype,
                        device=like.to_local().device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def spec_for(axes: Sequence[Optional[str]], mesh,
             rules: Dict[str, MeshAxis]) -> Tuple:
    """The placements of a tensor with logical ``axes`` on ``mesh``."""
    return placements(resolve_spec(axes, rules), mesh)


# ---------------------------------------------------------------------------
# FSDP's per-layer gather and the kernels' local shards
# ---------------------------------------------------------------------------

_WEIGHT_AXES = ("heads", "kv_heads", "ff", "inner", "vocab", "experts",
                "expert_ff")


def gather_weight(t: torch.Tensor) -> torch.Tensor:
    """One layer's weight as its layer body uses it: replicated over
    every mesh axis but the tensor-parallel ones of the active rules
    (FSDP's all-gather; autograd gives the gradient's reduce-scatter).
    A no-op without a mesh or for a plain tensor."""
    env = current()
    if env is None or not isinstance(t, DTensor):
        return t
    mesh, rules = env
    keep = set()
    for name in _WEIGHT_AXES:
        a = rules.get(name)
        keep.update((a,) if isinstance(a, str) else (a or ()))
    want = tuple(p if n in keep else Replicate()
                 for p, n in zip(t.placements, mesh.mesh_dim_names))
    if tuple(t.placements) == want:
        return t
    return t.redistribute(mesh, want)


def whole_heads(t: torch.Tensor, dim: int, n_heads: int) -> torch.Tensor:
    """``t`` with its dim ``dim`` (``n_heads`` heads of equal width,
    flattened) replicated over every mesh dim that shards it into
    pieces that are not whole heads, so it can be unflattened into
    heads (DTensor cannot unflatten an uneven split); counted in
    ``per_shard.heads_replicated``.  A plain tensor is returned as is."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 and n_heads % mesh.shape[i] else p
                 for i, p in enumerate(t.placements))
    if want == tuple(t.placements):
        return t
    per_shard.heads_replicated += 1
    return t.redistribute(mesh, want)


def _size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def batch_split(mesh, batch: int, taken: Sequence[bool] = ()) -> list:
    """Per mesh dim, whether it splits a tensor's ``batch`` rows: the
    batch axes (those ``taken`` marks excepted: they split another dim)
    when ``batch`` divides over all of them together, else none."""
    names = mesh.mesh_dim_names
    taken = list(taken) or [False] * len(names)
    rows = [n in BATCH_AXES and not taken[i] for i, n in enumerate(names)]
    n_b = 1
    for i, r in enumerate(rows):
        n_b *= mesh.shape[i] if r else 1
    return rows if batch % n_b == 0 else [False] * len(names)


def per_shard(fn: Callable, args: Sequence, dims: Sequence, out_dims:
              Sequence, *, batch: int, heads: Sequence[int]):
    """``fn`` on the local shards of ``args``, its outputs wrapped back
    as DTensors: a kernel's call under a mesh.  ``dims[i]`` is the
    (batch dim, heads dim) of ``args[i]`` (either None), or None for an
    argument passed as is; ``out_dims`` the same per output (one tuple
    if ``fn`` returns a tensor).  Batch goes over the batch axes where
    ``batch`` divides, heads over ``model`` where every count in
    ``heads`` divides (whole GQA groups); otherwise that dim is
    replicated first, and a replication of heads is counted in
    ``per_shard.heads_replicated`` (GSPMD pads uneven shards, DTensor
    splits them unevenly, and the kernels take whole groups).
    Differentiable both ways (``redistribute``, ``to_local``,
    ``from_local``)."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    names = mesh.mesh_dim_names
    rows = batch_split(mesh, batch)
    m = _size(mesh, TP) if TP in names else 1
    split_h = all(h % m == 0 for h in heads)
    per_shard.heads_replicated += int(not split_h)

    def place(bd, hd):
        return tuple(
            Shard(bd) if rows[i] and bd is not None
            else Shard(hd) if n == TP and split_h and hd is not None
            else Replicate() for i, n in enumerate(names))

    # a mesh dim the call is split over: an argument replicated on it
    # gets a partial gradient from each shard, summed over the dim
    od = [out_dims] if isinstance(out_dims[0], (int, type(None))) \
        else list(out_dims)
    used = [place(*d) for d in list(dims) + od if d is not None]
    split = [any(isinstance(pl[i], Shard) for pl in used)
             for i in range(len(names))]
    local = []
    for a, d in zip(args, dims):
        if d is None or a is None:
            local.append(a)
            continue
        a = as_dtensor(a, mesh)
        want = place(*d)
        if tuple(a.placements) != want:
            a = a.redistribute(mesh, want)
        grad_pl = [Partial() if split[i] and isinstance(p, Replicate)
                   else p for i, p in enumerate(want)]
        # (the kernels take contiguous tensors; a redistribution can
        # leave a strided local, e.g. after unpadding an uneven split)
        local.append(a.to_local(grad_placements=grad_pl).contiguous())
    out = fn(*local)
    single = isinstance(out, torch.Tensor)
    outs = (out,) if single else tuple(out)
    wrapped = tuple(DTensor.from_local(o, mesh, place(*d), run_check=False)
                    for o, d in zip(outs, od))
    return wrapped[0] if single else wrapped


per_shard.heads_replicated = 0
