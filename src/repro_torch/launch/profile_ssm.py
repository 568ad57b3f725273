"""Where a token model's prefill and decode spend their device time.

Builds a registry model (``--arch``, default ``mamba2-780m``) at full
width on the card with random weights from a seed (``--layers`` cuts
the depth; a hybrid model's to whole periods), then traces with
``torch.profiler`` one ``prefill`` of ``--batch`` x ``--seq`` tokens
(default 2 x 32,768; a VLM's first ``n_frontend_tokens`` of them are
image embeddings; an encoder-decoder also encodes ``n_frontend_tokens``
stub audio frames), 8 ``decode_step``s at that batch after that prefill
and, for the SSM family, 8 at batch 128 from ``init_cache`` (its decode
cost does not depend on the context), each after a warm-up.  For each
it prints the device time by kernel and by category, the host wall time
traced and untraced (the same steps run again without the profiler),
the device's idle share against both, and the kernels launched per
step::

    python -m repro_torch.launch.profile_ssm
    python -m repro_torch.launch.profile_ssm --arch granite-moe-1b-a400m
    python -m repro_torch.launch.profile_ssm --arch jamba-v0.1-52b --layers 8
    python -m repro_torch.launch.profile_ssm --arch whisper-medium
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.launch.profile_step import GEMM, report

ARCH = "mamba2-780m"
PROMPT = (2, 32768)          # prefill_32k's length, its batch cut to 2
WIDE_BATCH = 128             # decode_32k's batch
STEPS = 8


def category(name: str) -> str:
    """Coarse class of a kernel by name: the flash attention kernel, the
    SSD kernel (its tensor-core kernel, or its three CUDA-core passes),
    matmuls (the projections, the unembedding, decode's state readout),
    reductions (the RMS norms), copies, the MoE router's top-k / sort /
    scan, the rest."""
    low = name.lower()
    if "flash_mha" in low:
        return "flash_mha (CUDA kernel)"
    if "ssd_" in low:
        return "ssd_scan (CUDA kernel)"
    if any(k in low for k in GEMM + ("gemv", "gemm")):
        return "matmul / gemv"
    if "reduce" in low:
        return "reductions (RMS norms)"
    if any(k in low for k in ("copy", "cat", "memcpy", "memset", "fill")):
        return "copies / cat / fill"
    if any(k in low for k in ("topk", "sort", "scan")):
        return "top-k / sort / scan (MoE routing)"
    return "elementwise (conv taps, silu, softplus, exp, casts)"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=ARCH,
                    help="a registry config the port serves (dense, moe, "
                         "vlm, hybrid, encdec or ssm)")
    ap.add_argument("--batch", type=int, default=PROMPT[0])
    ap.add_argument("--seq", type=int, default=PROMPT[1],
                    help="prompt length (a multiple of 512 above 512: the "
                         "blocked attention schedule)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: full; "
                         "an encoder-decoder: each stack)")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_config
    from repro_torch.models import registry

    cfg = get_config(args.arch)
    if args.layers:
        cut = {"n_layers": args.layers}
        if cfg.family == "encdec":
            cut.update(n_enc_layers=args.layers, n_dec_layers=args.layers)
        cfg = dataclasses.replace(cfg, **cut)
    api = registry.get_api(cfg)
    if api.prefill is None:
        raise SystemExit(f"{args.arch}: no token serving surface")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init(cfg, gen, dev)
    b, s = args.batch, args.seq
    kw = {"max_len": s + 1}
    n_img = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    if n_img:
        kw["img_embeds"] = 0.02 * torch.randn(
            (b, n_img, cfg.d_model), generator=gen, device=dev).to(
                params["embed"].dtype)
    if cfg.family == "encdec":
        kw["audio_embeds"] = 0.02 * torch.randn(
            (b, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
            device=dev).to(params["embed"].dtype)
    tokens = torch.randint(0, cfg.vocab_size, (b, s - n_img),
                           generator=gen, device=dev)
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
        out["logits"], out["state"], out["pos"] = api.prefill(
            cfg, params, tokens, **kw)

    name = args.arch if not args.layers else \
        f"{args.arch} ({cfg.n_layers} layers)"
    profile(f"{name} prefill B={b} S={s}", prefill, 1)
    runs = [(b, out["state"])]
    if cfg.family == "ssm":
        runs.append((WIDE_BATCH, api.init_cache(cfg, WIDE_BATCH, s,
                                                device=dev)))
    for batch, state in runs:
        tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        pos = torch.full((batch,), s, dtype=torch.int32, device=dev)

        def step(state=state, tok=tok, pos=pos):
            api.decode_step(cfg, params, state, tok, pos)

        profile(f"{name} decode_step B={batch}, {STEPS} steps", step, STEPS)


if __name__ == "__main__":
    main()
