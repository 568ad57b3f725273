"""Per-device cost of a traced step, the port's counterpart of the JAX
reference's ``launch/hlo_cost.py`` (the name is kept so the two trees
diff file by file).  It reads no HLO: it counts the aten ops that one
rank dispatches while the step runs, eagerly, on fake tensors
(``launch/lowering.py``), so Python loops over layers unroll and no trip
count is needed.

    flops       ``torch.utils.flop_counter``'s formulas (2*M*N*K per
                product; convolutions and attention ops as it counts
                them), on the LOCAL tensors only
    hbm bytes   operand + result bytes of every local aten op that is not
                a view: an UNFUSED upper bound (the reference counts the
                traffic at XLA's fusion boundaries, which is lower)
    collective  result bytes of each functional collective
                (``_c10d_functional``), by kind, in the reference's names

DTensor's sharding propagator infers each new op's output shape by
running the op on fake tensors of the GLOBAL shapes (and caches the
result per op schema, so only an op's first use does it).  Those runs
are not the rank's work: ``DispatchCost`` switches counting off for
their duration, so the count does not depend on call order.  All
numbers are PER-DEVICE (rank 0's program).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_COLL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

_SKIP_BYTES = {"wait_tensor", "empty", "empty_strided", "empty_like",
               "zeros", "ones", "full", "arange", "scalar_tensor",
               "_local_scalar_dense", "lift_fresh", "lift_fresh_copy"}

_PROPAGATING = threading.local()
_DEVICE = torch.ops.prim.device.default


@dataclasses.dataclass
class HloCost:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_by_op: Dict[str, float]


def _bytes(t) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    if not isinstance(t, torch.Tensor):
        return 0
    return t.numel() * t.element_size()


class DispatchCost(TorchDispatchMode):
    """Counts FLOPs, bytes and collective bytes of the local aten ops
    dispatched inside it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_by_op: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _DEVICE:                # metadata, no work
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor dispatches its locals
        out = func(*args, **kwargs)
        if not getattr(_PROPAGATING, "on", False):
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            kind = _COLL_KINDS.get(name)
            if kind is not None:
                b = sum(_bytes(o) for o in tree_flatten(out)[0])
                self.coll_by_op[kind] = self.coll_by_op.get(kind, 0.0) + b
            return
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or name in _SKIP_BYTES:
            return
        ins = tree_flatten((args, kwargs))[0]
        self.hbm_bytes += sum(_bytes(t) for t in ins) + \
            sum(_bytes(t) for t in tree_flatten(out)[0])

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll_by_op.values()))

    def cost(self) -> HloCost:
        return HloCost(flops=self.flops, hbm_bytes=self.hbm_bytes,
                       coll_bytes=self.coll_bytes,
                       coll_by_op=dict(self.coll_by_op))


@contextlib.contextmanager
def _propagation_uncounted():
    """Switch counting off while DTensor infers an op's global output
    shape on fake tensors."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def wrapped(self, op_schema):
        prev = getattr(_PROPAGATING, "on", False)
        _PROPAGATING.on = True
        try:
            return orig(self, op_schema)
        finally:
            _PROPAGATING.on = prev

    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


@contextlib.contextmanager
def counting():
    """``with counting() as c: ...`` then ``c.cost()``."""
    mode = DispatchCost()
    with _propagation_uncounted(), mode:
        yield mode


def analyze(fn: Callable, *args, **kwargs) -> HloCost:
    """Cost of one call ``fn(*args, **kwargs)`` (run it as it is)."""
    with counting() as c:
        fn(*args, **kwargs)
    return c.cost()
