"""Quickstart: the three layers of the framework in about a minute, on
the port (the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. BMPR — the paper's fidelity router on its profiled Pareto frontier.
2. Cluster serving — the real control plane on a simulated 16-worker
   cluster (QoE / TTFC / quality, SS7 metrics).
3. Real model — one AR-DiT chunk generated at two fidelity configs
   (the reduced config; on the card by default, where attention runs
   the hand-written flash kernel).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.bmpr import BMPR
from repro_torch.core.fidelity import FidelityConfig, HIGHEST_QUALITY
from repro_torch.examples._device import resolve, sync
from repro_torch.models import ardit as A
from repro_torch.profiler.profiles import get_profile
from repro_torch.sched_sim.metrics import summarize
from repro_torch.sched_sim.policies import make_policy
from repro_torch.sched_sim.simulator import SimConfig, Simulator
from repro_torch.sched_sim.workloads import steady

FIDELITIES = (HIGHEST_QUALITY, FidelityConfig(2, 0.9, 1, "fp8"))


def bmpr_lines(model: str = "causal-forcing",
               budgets: Sequence[float] = (1.0, 0.5, 0.1)) -> List[str]:
    """The frontier's size and floor, then BMPR's pick per budget."""
    bmpr = BMPR(get_profile(model))
    lines = [f"Pareto frontier: {len(bmpr.frontier.points)} points, "
             f"quality floor {bmpr.frontier.q_floor:.2f}"]
    for budget in budgets:
        d = bmpr.select(budget)
        lines.append(f"  slack budget {budget:4.1f}s -> {d.fidelity.key:22s} "
                     f"({d.mode}, L={d.latency:.2f}s, Q={d.quality:.2f})")
    return lines


def cluster_row(n: int = 100, seed: int = 0) -> str:
    """The simulator's summary of ``n`` steady streams on 16 workers."""
    specs = steady(n=n, rate=1.0, seed=seed)
    res = Simulator(SimConfig(), specs, make_policy("slackserve")).run()
    return f"16-worker cluster, {n} streams: {summarize(res).row()}"


def model_inputs(cfg: ModelConfig, device: torch.device, seed: int = 0
                 ) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """Random params, text conditioning and chunk noise from one seeded
    generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = A.init_params(cfg, gen, device)
    cond = 0.02 * torch.randn((1, A.COND_TOKENS, cfg.d_model),
                              generator=gen, device=device)
    noise = torch.randn((1, A.chunk_tokens(cfg), A.LATENT_CH),
                        generator=gen, device=device)
    return params, cond, noise


def generate_chunks(cfg: ModelConfig, params: dict, cond: torch.Tensor,
                    noise: torch.Tensor,
                    fidelities: Sequence[FidelityConfig] = FIDELITIES
                    ) -> List[Tuple[FidelityConfig, torch.Tensor, float]]:
    """One chunk per fidelity config over one growing cache, each from
    ``noise``: (config, chunk, wall seconds)."""
    cache = A.init_cache(cfg, params, cond)
    out = []
    for fid in fidelities:
        t0 = time.perf_counter()
        chunk, cache = A.serve_chunk(cfg, params, cache, noise, fid)
        sync(noise.device)
        out.append((fid, chunk, time.perf_counter() - t0))
    return out


def main(argv: Optional[List[str]] = None) -> List[torch.Tensor]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the model (default: the card)")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    print("\n".join(bmpr_lines()))
    print("\n" + cluster_row())
    cfg = get_config("ardit-self-forcing").reduced()
    chunks = generate_chunks(cfg, *model_inputs(cfg, device))
    for fid, chunk, sec in chunks:
        print(f"\ngenerated chunk at {fid.key}: shape {tuple(chunk.shape)}, "
              f"{sec:.2f}s wall")
    print("done.")
    return [chunk for _, chunk, _ in chunks]


if __name__ == "__main__":
    main()
