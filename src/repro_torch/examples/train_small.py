"""Train a small LM end to end on the port: the synthetic data pipeline,
AdamW with the WSD schedule, microbatching, checkpointing and a
kill / restart (the reference's ``examples/train_small.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_small \\
        [--steps 40] [--arch minicpm-2b] [--device cpu]

Where the reference only prints that the resumed run is bitwise
identical to an uninterrupted one, this checks it: after the simulated
failure the run restores its checkpoint and trains to the end, then an
uninterrupted run takes the same steps, and every leaf of the
parameters and the optimizer state must be equal (``torch.equal``), or
the run raises.  The reduced config, on the card unless ``--device
cpu``.  The same driver trains full configs:
``python -m repro_torch.launch.train --arch minicpm-2b --full``.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, get_config
from repro_torch.data import pipeline as dp
from repro_torch.examples._device import resolve
from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt

SHAPE = ShapeConfig("ex", "train", 64, 4)
MICROBATCHES = 2


def opt_config(steps: int) -> opt.OptConfig:
    return opt.OptConfig(lr=1e-3, schedule="wsd", warmup_steps=4,
                         total_steps=steps)


def fresh_state(params) -> train_loop.TrainState:
    return train_loop.TrainState(params, opt.init_opt_state(params))


def train_steps(cfg: ModelConfig, step_fn: Callable,
                state: train_loop.TrainState, start: int, stop: int,
                log: bool = True) -> Tuple[train_loop.TrainState,
                                           List[float]]:
    """Steps ``start`` to ``stop`` on the pipeline's batches of those
    steps; returns the state and each step's loss."""
    losses = []
    for s in range(start, stop):
        state, m = step_fn(state, dp.global_batch(cfg, SHAPE, s))
        losses.append(float(m["loss"]))
        if log and s % 10 == 0:
            print(f"step {s:4d} loss {losses[-1]:.4f}")
    return state, losses


def state_leaves(state: train_loop.TrainState) -> Dict[str, torch.Tensor]:
    """Every leaf of the parameters and the optimizer state by name."""
    o = state.opt_state
    out = {"opt/step": o.step}
    for prefix, tree in (("params", state.params), ("opt/m", o.m),
                         ("opt/v", o.v)):
        out.update({"/".join((prefix,) + path): t
                    for path, t in opt.leaves_with_path(tree)})
    return out


def check_resume(resumed: train_loop.TrainState,
                 straight: train_loop.TrainState) -> int:
    """Raise unless every leaf of ``resumed`` equals ``straight``'s bit
    for bit; returns the number of leaves compared."""
    got, want = state_leaves(resumed), state_leaves(straight)
    if got.keys() != want.keys():
        raise AssertionError(f"resumed state has leaves {sorted(got)}, the "
                             f"uninterrupted run {sorted(want)}")
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if differ:
        raise AssertionError(f"the resumed run differs from an "
                             f"uninterrupted one in {len(differ)} of "
                             f"{len(want)} leaves: {differ[:8]}")
    return len(want)


def run(cfg: ModelConfig, make_params: Callable[[], dict], steps: int,
        ckpt_dir: str) -> Dict[str, object]:
    """Half the steps, a checkpoint, a restart from fresh params restored
    from it, the other half; then the same steps uninterrupted, and
    ``check_resume``.  ``make_params`` returns new parameters each call
    (the same values every time)."""
    step_fn = train_loop.make_train_step(cfg, opt_config(steps),
                                         microbatches=MICROBATCHES)
    half = steps // 2
    state, losses = train_steps(cfg, step_fn, fresh_state(make_params()), 0,
                                half)
    ckpt.save(ckpt_dir, half, state)
    print(f"--- simulated failure at step {half}; restarting ---")
    resumed = ckpt.restore(ckpt_dir, ckpt.latest_step(ckpt_dir),
                           fresh_state(make_params()))
    resumed, rest = train_steps(cfg, step_fn, resumed, half, steps)
    straight, straight_losses = train_steps(
        cfg, step_fn, fresh_state(make_params()), 0, steps, log=False)
    n = check_resume(resumed, straight)
    print(f"final loss {rest[-1]:.4f} (the resumed run equals an "
          f"uninterrupted one bit for bit: {n} leaves of the parameters "
          f"and optimizer state checked)")
    return {"losses": losses + rest, "straight_losses": straight_losses,
            "resumed": resumed, "straight": straight}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--device", default="cuda",
                    help="device of the training (default: the card)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = get_config(args.arch).reduced()
    api = registry.get_api(cfg)

    def make_params():
        return api.init(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device)

    with tempfile.TemporaryDirectory() as d:
        return run(cfg, make_params, args.steps, d)


if __name__ == "__main__":
    main()
