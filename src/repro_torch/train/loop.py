"""The train step, a port of the JAX reference's ``train/loop.py``.

``make_train_step`` builds the step for any registered model family:
the family's loss, its gradients by autograd (``loss.backward()``, then
each parameter's ``.grad``), then AdamW.  Microbatching accumulates the
microbatches' losses and gradients into fp32 zeros in the reference's
order, then divides by their number.  Remat is inside each model's
``forward``.

Under a mesh the same step runs on DTensor state
(``make_sharded_train_step``): the parameters and the ZeRO moments laid
out by ``state_shardings`` (TP x FSDP x DP from
``distributed.sharding``), the batch by ``batch_shardings``, the model
code under the reference's logical-axis rules.  AdamW updates the
DTensors in place, the global grad norm is a DTensor reduction (a
Partial sum all-reduced), and each microbatch is the same slice of
every rank's batch shard.  ``lower_train_step`` traces one such step
on fake tensors for the dry-run (``launch/lowering.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.logical import P, logical_axis_rules
from repro_torch.models import registry
from repro_torch.models.layers import tree_map
from repro_torch.train import optimizer as opt


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: opt.OptState


def loss_for(cfg: ModelConfig) -> Callable:
    api = registry.get_api(cfg)
    return lambda params, batch: api.loss(cfg, params, batch)


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of the data pipeline (numpy) as tensors on ``device``
    (DTensors stay as they are)."""
    return {k: v if isinstance(v, DTensor) else torch.as_tensor(v).to(device)
            for k, v in batch.items()}


def _microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` along the batch dim; of a DTensor, the
    same slice of every rank's local rows."""
    if isinstance(x, DTensor):
        loc = x.to_local()
        mb = loc.shape[0] // n
        return DTensor.from_local(loc[i * mb:(i + 1) * mb], x.device_mesh,
                                  x.placements, run_check=False)
    mb = x.shape[0] // n
    return x[i * mb:(i + 1) * mb]


def value_and_grad(loss_fn: Callable, params: Any,
                   batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor,
                                                            Any]:
    """(loss, gradient tree) of ``loss_fn(params, batch)``; a parameter
    the loss does not reach gets a zero gradient, as in JAX.  The
    parameters come back without ``requires_grad``."""
    leaves = [p for _, p in opt.leaves_with_path(params)]
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    try:
        loss = loss_fn(params, batch)
        loss.backward()
        grads = tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, opt_cfg: opt.OptConfig,
                    *, microbatches: int = 1) -> Callable:
    """(state, batch) -> (state, metrics).  The batch may be numpy (the
    data pipeline's) or tensors; it moves to the parameters' device.
    The state's parameters and moments are updated in place
    (``optimizer.adamw_update``)."""
    loss_fn = loss_for(cfg)

    def step(state: TrainState, batch: Dict[str, Any]):
        dev = next(opt.leaves_with_path(state.params))[1].device
        batch = to_device(batch, dev)
        if microbatches <= 1:
            loss, grads = value_and_grad(loss_fn, state.params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            for i in range(microbatches):
                part = {k: _microbatch(v, i, microbatches)
                        for k, v in batch.items()}
                l, g = value_and_grad(loss_fn, state.params, part)
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        params, opt_state, metrics = opt.adamw_update(
            opt_cfg, state.params, grads, state.opt_state)
        metrics["loss"] = loss
        return TrainState(params, opt_state), metrics

    return step


# ---------------------------------------------------------------------------
# sharded state and step
# ---------------------------------------------------------------------------

def state_shardings(cfg: ModelConfig, mesh) -> TrainState:
    """NamedSharding tree for TrainState (ZeRO: moments follow params;
    the step is replicated)."""
    p_shard = shd.param_shardings(registry.param_specs(cfg), mesh,
                                  ep=cfg.moe_ep, layout=cfg.parallel_layout)
    return TrainState(
        params=p_shard,
        opt_state=opt.OptState(step=shd.NamedSharding(mesh, P()),
                               m=p_shard, v=p_shard))


def batch_shardings(cfg: ModelConfig, mesh, batch_spec: Any) -> Any:
    """Batch dim over the batch axes of the layout, the rest replicated."""
    bp = shd.batch_pspec(mesh, layout=cfg.parallel_layout)
    return {k: shd.NamedSharding(mesh, P(*(tuple(bp) + (None,) * (
        len(leaf.shape) - 1)))) for k, leaf in batch_spec.items()}


def distribute_state(state: TrainState, shardings: TrainState) -> TrainState:
    """``state`` as DTensors laid out by ``shardings`` (rank 0's values)."""
    o, so = state.opt_state, shardings.opt_state
    return TrainState(
        shd.distribute(state.params, shardings.params),
        opt.OptState(shd.distribute(o.step, so.step),
                     shd.distribute(o.m, so.m), shd.distribute(o.v, so.v)))


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: opt.OptConfig, mesh,
                            *, microbatches: int = 1) -> Callable:
    """``make_train_step``'s step under the reference's training rules on
    ``mesh`` (state and batch DTensors, ``distribute_state`` /
    ``shd.distribute``)."""
    step = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    rules = shd.train_rules(mesh, ep=cfg.moe_ep, layout=cfg.parallel_layout)

    def wrapped(state: TrainState, batch: Dict[str, Any]):
        with logical_axis_rules(mesh, rules):
            return step(state, batch)

    return wrapped


def lower_train_step(cfg: ModelConfig, mesh, shape,
                     opt_cfg: Optional[opt.OptConfig] = None,
                     microbatches: int = 1):
    """Trace (not run) the sharded train step for the dry-run: one call
    on fake stand-ins of the state and batch (``launch.lowering``)."""
    from repro_torch.launch import lowering
    opt_cfg = opt_cfg or opt.OptConfig(
        schedule="wsd" if cfg.name.startswith("minicpm") else "cosine")
    step = make_sharded_train_step(cfg, opt_cfg, mesh,
                                   microbatches=microbatches)
    st_shard = state_shardings(cfg, mesh)
    batch_spec = registry.input_specs(cfg, shape)
    p_specs = registry.param_specs(cfg)

    def f32(t):
        return torch.empty(t.shape, dtype=torch.float32, device="meta")

    state_spec = TrainState(p_specs, opt.OptState(
        torch.empty((), dtype=torch.int32, device="meta"),
        tree_map(f32, p_specs), tree_map(f32, p_specs)))

    return lowering.trace(step, (state_spec, batch_spec),
                          (st_shard, batch_shardings(cfg, mesh, batch_spec)),
                          mesh)
