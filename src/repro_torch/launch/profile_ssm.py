"""Where ``mamba2-780m`` prefill and decode spend their device time.

Builds full-width ``mamba2-780m`` on the card with random bf16 weights
from a seed, then traces with ``torch.profiler`` one ``prefill`` of
2 x 32,768 tokens, 8 ``decode_step``s at batch 2 (after that prefill)
and 8 at batch 128 (from ``init_cache``), each after a warm-up.  For
each it prints the device time by kernel and by category, the host wall
time traced and untraced (the same steps run again without the
profiler), the device's idle share against both, and the kernels
launched per step::

    python -m repro_torch.launch.profile_ssm
"""
from __future__ import annotations

import time

import torch

from repro_torch.launch.profile_step import GEMM, report

ARCH = "mamba2-780m"
PROMPT = (2, 32768)          # prefill_32k's length, its batch cut to 2
WIDE_BATCH = 128             # decode_32k's batch
STEPS = 8


def category(name: str) -> str:
    """Coarse class of a kernel by name: the SSD kernel (its tensor-core
    kernel, or its three CUDA-core passes),
    matmuls (the projections, the unembedding, decode's state readout),
    reductions (the RMS norms), copies, the rest."""
    low = name.lower()
    if "ssd_" in low:
        return "ssd_scan (CUDA kernel)"
    if any(k in low for k in GEMM + ("gemv", "gemm")):
        return "matmul / gemv"
    if "reduce" in low:
        return "reductions (RMS norms)"
    if any(k in low for k in ("copy", "cat", "memcpy", "memset", "fill")):
        return "copies / cat / fill"
    return "elementwise (conv taps, silu, softplus, exp, casts)"


def main() -> None:
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry

    cfg = get_config(ARCH)
    api = registry.get_api(cfg)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    params = api.init(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, PROMPT, generator=gen).to(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def timed(fn, steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def profile(title, fn, steps):
        fn()                                       # warm this shape
        untraced = timed(fn, steps)
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            wall = timed(fn, steps)
        report(prof, category, steps, wall, title, untraced)

    out = {}

    def prefill():
        out["logits"], out["state"], out["pos"] = api.prefill(cfg, params,
                                                              tokens)

    profile(f"{ARCH} prefill B={PROMPT[0]} S={PROMPT[1]}", prefill, 1)
    for batch, state in ((PROMPT[0], out["state"]),
                         (WIDE_BATCH, api.init_cache(cfg, WIDE_BATCH,
                                                     PROMPT[1], device=dev))):
        tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        pos = torch.full((batch,), PROMPT[1], dtype=torch.int32, device=dev)

        def step(state=state, tok=tok, pos=pos):
            api.decode_step(cfg, params, state, tok, pos)

        profile(f"{ARCH} decode_step B={batch}, {STEPS} steps", step, STEPS)


if __name__ == "__main__":
    main()
