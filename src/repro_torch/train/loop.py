"""The train step on one device, a port of the JAX reference's
``train/loop.py``.

``make_train_step`` builds the step for any registered model family:
the family's loss, its gradients by autograd (``loss.backward()``, then
each parameter's ``.grad``), then AdamW.  Microbatching accumulates the
microbatches' losses and gradients into fp32 zeros in the reference's
order, then divides by their number.  Remat is inside each model's
``forward``.  The sharded wiring (``state_shardings``,
``batch_shardings``, ``lower_train_step``) waits for ROADMAP
'Waiting 2' (distribution).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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
    """A batch of the data pipeline (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


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
            mb = next(iter(batch.values())).shape[0] // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=dev), state.params)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
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
