"""Where a training step spends its device time.

Builds a registry model (``--arch``, default ``minicpm-2b``) at full
width on the card with random weights from a seed (``--layers`` cuts the
depth), then runs ``train/loop.make_train_step`` on one batch of the
data pipeline (``--batch`` x ``--seq``; an AR-DiT takes ``--seq // 2640``
chunks): one step to warm up, ``--steps`` steps untraced, the same
steps traced with ``torch.profiler``.  It prints the device time by
kernel and by category (kernel 3's forward and backward apart), the
host wall time traced and untraced, the device's idle share against
both, and the kernels launched per step::

    python -m repro_torch.launch.profile_train
    python -m repro_torch.launch.profile_train --arch ardit-self-forcing \\
        --batch 1 --seq 5280
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.launch.profile_ssm import category as token_category
from repro_torch.launch.profile_step import report


# the kernels of csrc/flash_mha_bwd.cu (anonymous namespace: the traced
# names carry the functions' names only)
BWD_KERNELS = ("bwd_delta_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel")


def category(name: str) -> str:
    """``profile_ssm.category``, with kernel 3's backward apart from its
    forward."""
    if any(k in name for k in BWD_KERNELS):
        return "flash_mha backward (CUDA kernel)"
    return token_category(name)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: full)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-5)
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.models import registry
    from repro_torch.train import loop, optimizer as opt

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = torch.device("cuda")
    params = registry.get_api(cfg).init(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = loop.TrainState(params, opt.init_opt_state(params))
    step_fn = loop.make_train_step(cfg, opt.OptConfig(lr=args.lr))
    batch = dp.global_batch(
        cfg, ShapeConfig("profile", "train", args.seq, args.batch), 0)

    def step():
        nonlocal state
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])              # waits for the step

    def timed(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    step()                                  # warm-up
    untraced = timed(args.steps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        wall = timed(args.steps)
    name = args.arch if not args.layers else \
        f"{args.arch} ({cfg.n_layers} layers)"
    report(prof, category, args.steps, wall,
           f"{name} train step B={args.batch} S={args.seq}", untraced)
    print(f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
          f"GiB")


if __name__ == "__main__":
    main()
