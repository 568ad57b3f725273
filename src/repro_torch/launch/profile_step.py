"""Where a batched denoise step, or a sequential chunk, spends its
device time.

Builds a ``BatchedChunkExecutor`` for full-width ``ardit-self-forcing``
(or ``--arch ardit-causal-forcing``: 16 heads of 96, kernel 1's D 96
instance) on the card with random weights from a seed (adaLN gates
opened), fills
3 streams to ``--fill`` chunks of context, then traces 2 batched steps
with ``torch.profiler`` and prints the device time by kernel and by
category (the paged attention kernel, the attention segments' fp32
matmuls, the linear layers' matmuls, the rest), next to the steps' host
wall time and the device's idle share.  With ``--sequential`` it runs
the ``SequentialChunkExecutor`` instead: one stream filled to ``--fill``
chunks, then one whole top-fidelity chunk traced (every attention call
through the flash kernel)::

    python -m repro_torch.launch.profile_step            # 2 chunks
    python -m repro_torch.launch.profile_step --fill 7   # full window
    python -m repro_torch.launch.profile_step --arch ardit-causal-forcing \
        --fill 7
    python -m repro_torch.launch.profile_step --sequential --fill 2
"""
from __future__ import annotations

import argparse
import collections
import time

import torch

ARCHS = ("ardit-self-forcing", "ardit-causal-forcing")
STREAMS = 3
STEPS = 2
GEMM = ("gemm", "cutlass", "xmma", "cublas", "nvjet")


def category(name: str) -> str:
    """Coarse class of a kernel by name: the paged kernel, fp32 matmuls
    (cuBLAS ``f32f32`` kernels: the einsums of the attention segments),
    other matmuls (the bf16 linear layers), exp and reductions, the
    rest."""
    low = name.lower()
    if "paged_chunk_attention" in low:
        return "paged_chunk_attention (CUDA kernel)"
    if "flash_mha" in low:
        return "flash_mha (CUDA kernel)"
    if any(k in low for k in GEMM):
        if "f32f32" in low:
            return "matmul fp32 (attention einsums)"
        return "matmul (linear layers)"
    if any(k in low for k in ("exp", "reduce", "max", "sum", "softmax")):
        return "exp / reductions"
    return "other elementwise / copies"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fill", type=int, default=2,
                    help="chunks of context each stream holds when traced")
    ap.add_argument("--sequential", action="store_true",
                    help="trace one whole chunk of the sequential executor")
    ap.add_argument("--arch", choices=ARCHS, default=ARCHS[0])
    args = ap.parse_args()

    from repro_torch.configs.base import get_config
    from repro_torch.core.fidelity import FidelityConfig
    from repro_torch.models import ardit as A
    from repro_torch.serve.batcher import BatchedChunkExecutor

    cfg = get_config(args.arch)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    params = A.open_gates(A.init_params(cfg, gen, dev), gen)
    fid = FidelityConfig(4, 0.0, cfg.ardit_window_chunks, "bf16")
    ctx = A.COND_TOKENS + args.fill * A.chunk_tokens(cfg)
    if args.sequential:
        profile_sequential(cfg, params, dev, fid, args.fill, ctx)
        return
    ex = BatchedChunkExecutor(cfg=cfg, params=params, max_streams=STREAMS,
                              device=dev)
    sids = list(range(STREAMS))
    for sid in sids:
        ex.admit(sid, seed=sid)
    for _ in range(args.fill):                    # fill the rings
        for sid in sids:
            ex.begin_chunk(sid, fid, 0.0)
        while ex.inflight:
            ex.run_step(sids)
    for sid in sids:
        ex.begin_chunk(sid, fid, 0.0)
    ex.run_step(sids)                             # warm this shape
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            ex.run_step(sids)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0

    report(prof, category, STEPS, wall,
           f"{cfg.name}: {STREAMS} rows, context {ctx} tokens, {STEPS} "
           f"steps")


def profile_sequential(cfg, params, dev, fid, fill: int, ctx: int) -> None:
    """One stream on the sequential executor: ``fill`` chunks, then one
    chunk traced (4 denoise steps and the clean forward)."""
    from repro_torch.serve.executor import SequentialChunkExecutor

    ex = SequentialChunkExecutor(cfg=cfg, params=params, device=dev)
    ex.admit(0, seed=0)
    for _ in range(fill):
        ex.begin_chunk(0, fid, 0.0)
        ex.run_step([0])
    ex.begin_chunk(0, fid, 0.0)
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        ex.run_step([0])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    report(prof, category, 1, wall,
           f"{cfg.name}: sequential, 1 row, context {ctx} tokens, one "
           f"chunk")


def report(prof, category, steps: int, wall: float, title: str,
           untraced: float = 0.0) -> None:
    """Print the device time of a ``torch.profiler`` trace of ``steps``
    steps by kernel and by ``category(name)``, per step, beside the
    steps' host wall time ``wall`` (seconds, traced) and the device's
    idle share; with ``untraced`` (seconds for the same steps run
    without the profiler), the idle share against that time too."""
    by_cat: collections.Counter = collections.Counter()
    by_name = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.device_time_total
        if us <= 0:
            continue
        by_name.append((us, ev.count, ev.key))
        by_cat[category(ev.key)] += us
    busy_ms = sum(by_cat.values()) / 1e3 / steps
    step_ms = wall * 1e3 / steps
    launches = sum(count for _, count, _ in by_name) / steps
    line = (f"{title}: wall {step_ms:.1f} ms/step, device busy "
            f"{busy_ms:.1f} ms/step ({100 * busy_ms / step_ms:.1f}%), idle "
            f"{100 * (1 - busy_ms / step_ms):.1f}%, {launches:.0f} kernels "
            f"per step")
    if untraced:
        plain_ms = untraced * 1e3 / steps
        line += (f"; untraced wall {plain_ms:.1f} ms/step, idle "
                 f"{100 * max(0.0, 1 - busy_ms / plain_ms):.1f}%")
    print(line)
    for label, us in by_cat.most_common():
        print(f"  {label:40s} {us / 1e3 / steps:9.2f} ms/step "
              f"{100 * us / 1e3 / steps / busy_ms:5.1f}%")
    print("  top kernels (ms/step, calls/step):")
    for us, count, name in sorted(by_name, reverse=True)[:12]:
        print(f"    {us / 1e3 / steps:9.2f}  {count / steps:6.1f}"
              f"  {name[:100]}")

if __name__ == "__main__":
    main()
