"""Training launcher: real steps on one device (the card by default).

    PYTHONPATH=src python -m repro_torch.launch.train [--arch minicpm-2b]
        [--steps 20 --batch 4 --seq 128] [--full] [--ckpt-dir DIR]
        [--device cuda|cpu]

A port of the JAX reference's ``launch/train.py``: the synthetic data
pipeline, AdamW + schedule (WSD for minicpm), microbatching and async
checkpoint / restart (resume is automatic when ``--ckpt-dir`` holds a
checkpoint, with bitwise-identical data).  Without ``--full`` it trains
the tiny same-family config (``reduced()``).  ``--device`` defaults to
the card and raises without one unless ``--device cpu`` is given.  Each
step prints the reference's line (``loss= gnorm= lr= (s/step)``, the
seconds a step averaged since the start) and, on the card, tokens/s at
that rate and the peak memory.  ``--fixed-batch`` trains every step on
step 0's batch, so that the loss must fall (the chip check's smoke
run).  Weights are random, drawn from a generator seeded with 0 on the
device.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data import pipeline as dp
from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt


def build_parser() -> argparse.ArgumentParser:
    """The launcher's options: every option of the reference's
    ``launch/train.py``, plus ``--device`` and ``--fixed-batch``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (needs the card)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--fixed-batch", action="store_true",
                    help="train every step on step 0's batch")
    return ap


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, list]:
    """Run the training; returns each step's loss, grad norm, seconds
    and peak memory (GiB, the card only) for callers such as the chip
    check."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.train: no CUDA device (pass --device cpu "
                           "to train on the CPU)")
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    api = registry.get_api(cfg)

    ocfg = opt.OptConfig(
        lr=args.lr, total_steps=max(args.steps, 10),
        warmup_steps=max(2, args.steps // 10),
        schedule="wsd" if args.arch.startswith("minicpm") else "cosine")
    step_fn = train_loop.make_train_step(cfg, ocfg,
                                         microbatches=args.microbatches)

    start = 0
    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init(cfg, gen, device=device)
    state = train_loop.TrainState(params, opt.init_opt_state(params))
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state = ckpt.restore(args.ckpt_dir, latest, state)
            start = latest
            print(f"resumed from step {start}")

    on_card = device.type == "cuda"
    out: Dict[str, list] = {"loss": [], "grad_norm": [], "seconds": [],
                            "peak_gib": []}
    pending = None
    t0 = time.time()
    for step in range(start, args.steps):
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t_step = time.time()
        batch = dp.global_batch(cfg, shape, 0 if args.fixed_batch else step)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])       # waits for the step
        out["seconds"].append(time.time() - t_step)
        out["loss"].append(loss)
        out["grad_norm"].append(float(metrics["grad_norm"]))
        per = (time.time() - t0) / (step - start + 1)
        line = (f"step {step:5d} loss={loss:.4f} "
                f"gnorm={out['grad_norm'][-1]:.3f} "
                f"lr={float(metrics['lr']):.2e} ({per:.2f}s/step)")
        if on_card:
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
            out["peak_gib"].append(peak)
            line += (f" {args.batch * args.seq / per:.0f} tokens/s, "
                     f"peak {peak:.2f} GiB")
        print(line, flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save(args.ckpt_dir, step + 1, state,
                                blocking=False)
    if pending is not None:
        pending.join()
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, state)
        print(f"final checkpoint at step {args.steps}")
    return out


if __name__ == "__main__":
    main()
