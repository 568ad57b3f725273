#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Card: name and power limit from nvidia-smi; build every CUDA kernel
   of the main path from ``src/repro_torch/kernels/*/csrc`` with nvcc.
2. Kernel vs plain version on the card at the main path's full-width
   shapes (ardit-self-forcing: Sq = 2640, Hq = Hkv = 12, D = 128, page =
   2640, 8-entry tables): all-visible, explicit mask with drops / a
   hole row / a row that sees nothing, GQA, fp32 and fp8 pages.  Times
   the kernel, the plain version and one PyTorch library call computing
   the same attention, and computes the card's bound for the work.
3. Integration: the reduced config's ``denoise_step_paged`` on the card
   (through the kernel) against the same step on the CPU (plain).
4. The main path at full width: a ``StreamingSession`` serving three
   streams of three chunks of ``ardit-self-forcing`` (random weights
   from a seed, adaLN gates opened), with the kernel launch count held
   to ``n_layers x dispatch_count``.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Without a CUDA device, or outside a checkout of the repository,
it exits non-zero and prints no result.
"""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is
# the larger of its bytes over the memory rate and its operations over
# the peak rate of its input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float8_e4m3fn": 1979e12,
              "torch.float32": 67e12}

NEG_INF = -1e30
# kernel vs plain version: both accumulate in fp32 and differ only in
# summation order (the limits of tests/test_torch_kernel_cuda.py)
TOL_M, TOL_L_REL, TOL_O = 1e-4, 1e-4, 1e-4
# paged_mha (bf16 output) vs SDPA over the same keys: outputs reach
# about 0.06, where a bf16 ulp is 2.4e-4; the limit is 8 ulps
TOL_SDPA = 2e-3

DEV = "cuda"
# the main path's attention shapes at full width (ardit-self-forcing):
# chunk of 3 x 880 tokens, 12 heads of 128, one page per chunk, tables
# of the sink page + a 7-chunk ring, a sink of 77 conditioning tokens
KERNEL_SHAPES = dict(B=2, Sq=2640, H=12, D=128, page=2640, n=8, sink=77)
SESSION_ARCH = "ardit-self-forcing"


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters):
    """Mean device milliseconds of ``fn()`` over ``iters`` calls, after
    one warm-up call (CUDA events around the whole run)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def finalize(m, l, acc):
    return acc / torch.where(l == 0, 1.0, l)[..., None]


def compare_partials(name, got, want):
    """Kernel partials against the plain version's on the same inputs:
    m within TOL_M, l within TOL_L_REL relative, the finalized output
    acc / l within TOL_O; rows that see nothing must be exactly
    (NEG_INF, 0, 0)."""
    (m, l, acc), (m0, l0, acc0) = got, want
    dead = m0 == NEG_INF
    if not torch.equal(m == NEG_INF, dead):
        raise AssertionError(f"{name}: rows that see nothing differ")
    if dead.any() and (l[dead].abs().max() > 0 or acc[dead].abs().max() > 0):
        raise AssertionError(f"{name}: a row that sees nothing has l/acc")
    live = ~dead
    err_m = float((m - m0)[live].abs().max()) if live.any() else 0.0
    err_l = float(((l - l0).abs() / l0.clamp_min(1e-30))[live].max()) \
        if live.any() else 0.0
    err_o = float((finalize(m, l, acc) - finalize(m0, l0, acc0)).abs().max())
    print(f"  {name}: |dm| {err_m:.3g} (limit {TOL_M:g})  |dl|/l "
          f"{err_l:.3g} (limit {TOL_L_REL:g})  |do| {err_o:.3g} "
          f"(limit {TOL_O:g})")
    if not (err_m <= TOL_M and err_l <= TOL_L_REL and err_o <= TOL_O):
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version (m {err_m}, l {err_l}, o {err_o})")
    return err_o


def paged_case(gen, B, Sq, Hq, Hkv, D, page, n, q_dtype, kv_dtype):
    """Random pool, queries and per-row block tables (distinct pages per
    row) on the card, from the device generator ``gen``."""
    dev = DEV
    P = B * n + 2
    q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(q_dtype)
    kp = torch.randn((P, page, Hkv, D), generator=gen, device=dev)
    vp = torch.randn((P, page, Hkv, D), generator=gen, device=dev)
    kp, vp = kp.to(kv_dtype), vp.to(kv_dtype)
    perm = torch.randperm(P, generator=gen, device=dev)[:B * n]
    table = perm.view(B, n).to(torch.int32)
    return q, kp.contiguous(), vp.contiguous(), table


def phase_kernel(record):
    """Phase 2: the kernel against its plain version at the main path's
    shapes; timings and the bound of the all-visible main case."""
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.models.attention import paged_mha

    gen = torch.Generator(device=DEV).manual_seed(1234)
    B, Sq, H, D, page, n, sink = (KERNEL_SHAPES[k] for k in (
        "B", "Sq", "H", "D", "page", "n", "sink"))
    tc = page
    bf16 = torch.bfloat16
    errs = []

    # (a) the main path's all-visible fast path: sink + 7 full ring pages
    q, kp, vp, table = paged_case(gen, B, Sq, H, H, D, page, n, bf16, bf16)
    hint = dict(sink=sink, chunk_tokens=tc)

    def kern():
        return ops.paged_chunk_attention(q, kp, vp, table, None, **hint)

    def plain():
        return ref.paged_chunk_attention_ref(q, kp, vp, table, None, **hint)

    errs.append(compare_partials("all-visible bf16", kern(), plain()))
    kernel_ms = cuda_ms(kern, 10)
    plain_ms = cuda_ms(plain, 3)

    # the library yardstick: SDPA over the gathered visible context plus
    # the chunk's own KV (the merged output, not the partials)
    ck = torch.randn((B, Sq, H, D), generator=gen, device=DEV).to(bf16)
    cv = torch.randn((B, Sq, H, D), generator=gen, device=DEV).to(bf16)
    bt = table.long()
    k_ctx = torch.cat([kp[bt[:, 0], :sink],
                       kp[bt[:, 1:].reshape(-1), :tc].view(B, -1, H, D)], 1)
    v_ctx = torch.cat([vp[bt[:, 0], :sink],
                       vp[bt[:, 1:].reshape(-1), :tc].view(B, -1, H, D)], 1)
    k_all = torch.cat([k_ctx, ck], 1).transpose(1, 2).contiguous()
    v_all = torch.cat([v_ctx, cv], 1).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()

    def library():
        return F.scaled_dot_product_attention(qt, k_all, v_all)

    library_ms = cuda_ms(library, 5)
    merged = paged_mha(q, kp, vp, table, None, ck, cv, n_kv_heads=H, **hint)
    lib_err = float((merged.float()
                     - library().transpose(1, 2).float()).abs().max())
    print(f"  paged_mha (kernel + in-chunk merge) vs SDPA: |d| {lib_err:.3g} "
          f"(limit {TOL_SDPA:g})")
    if not lib_err <= TOL_SDPA:
        raise AssertionError(f"paged_mha disagrees with SDPA ({lib_err})")

    # bound of case (a): each input read once, each output written once;
    # 4 * rows * D * visible tokens operations per (b, kv head)
    ctx = sink + (n - 1) * tc
    flops = 4.0 * B * H * Sq * D * ctx
    nbytes = (q.numel() * q.element_size()
              + 2 * B * ctx * H * D * kp.element_size()
              + table.numel() * 4 + B * H * Sq * (D + 2) * 4)
    t_ops = flops / PEAK_FLOPS[str(kp.dtype)] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"  all-visible B={B} ctx={ctx}: kernel {kernel_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, SDPA {library_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}; {flops / 1e12:.3f} TFLOP, "
          f"{nbytes / 1e6:.1f} MB), achieved "
          f"{flops / kernel_ms / 1e9:.2f} TFLOP/s")
    del k_ctx, v_ctx, k_all, v_all, qt, merged

    # (b) explicit mask: sparsity-style 128-token drops on ring pages, a
    # hole row (ring entry 3 remapped to the row's sink page, mask slice
    # false) and a row that sees nothing at all
    mask = torch.zeros((B, n, page), dtype=torch.bool, device=DEV)
    mask[:, 0, :sink] = True
    mask[:, 1:, :tc] = True
    for j in range(1, n - 1):
        mask[0, j, 128 * j:128 * (j + 2)] = False
    table_b = table.clone()
    table_b[0, 3] = table_b[0, 0]
    mask[0, 3] = False
    mask[1] = False
    mask = mask.view(B, n * page)
    errs.append(compare_partials(
        "masked bf16 (drops, hole, empty row)",
        ops.paged_chunk_attention(q, kp, vp, table_b, mask, **hint),
        ref.paged_chunk_attention_ref(q, kp, vp, table_b, mask, **hint)))
    # ... and the same mask without the extent hint (full pages)
    errs.append(compare_partials(
        "masked bf16, full pages",
        ops.paged_chunk_attention(q, kp, vp, table_b, mask),
        ref.paged_chunk_attention_ref(q, kp, vp, table_b, mask)))

    # (e) fp8-e4m3 pages under the same tables, all visible
    from repro_torch.models.kvcache import to_fp8_e4m3
    kf, vf = to_fp8_e4m3(kp), to_fp8_e4m3(vp)
    errs.append(compare_partials(
        "all-visible fp8 pages",
        ops.paged_chunk_attention(q, kf, vf, table, None, **hint),
        ref.paged_chunk_attention_ref(q, kf, vf, table, None, **hint)))
    del kf, vf, q, kp, vp

    # (c) GQA, group of 4, random token mask
    gq, gpage = max(8, Sq // 10), max(16, page // 5)
    q, kp, vp, table = paged_case(gen, 2, gq, 16, 4, D, gpage, 4, bf16,
                                  bf16)
    mask = torch.rand((2, 4 * gpage), generator=gen, device=DEV) < 0.6
    errs.append(compare_partials(
        "GQA G=4 masked",
        ops.paged_chunk_attention(q, kp, vp, table, mask),
        ref.paged_chunk_attention_ref(q, kp, vp, table, mask)))

    # (d) fp32 queries and pages (the reduced configs' dtype), 3 entries
    q, kp, vp, table = paged_case(gen, B, Sq, H, H, D, page, 3,
                                  torch.float32, torch.float32)
    errs.append(compare_partials(
        "all-visible fp32",
        ops.paged_chunk_attention(q, kp, vp, table, None, **hint),
        ref.paged_chunk_attention_ref(q, kp, vp, table, None, **hint)))
    del q, kp, vp
    torch.cuda.empty_cache()

    record.update(max_abs_err=max(errs), ms=kernel_ms, kernel_ms=kernel_ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=library_ms)


def phase_integration():
    """Phase 3: the reduced config's fused denoise step on the card
    (kernel) and on the CPU (plain version), same params and inputs,
    masks None / denoise / denoise + clean.  fp32 throughout, TF32 off:
    agreement within 1e-4."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import ardit as A
    from repro_torch.models import kvcache
    from repro_torch.models.convert import params_to

    cfg = dataclasses.replace(get_config("ardit-self-forcing").reduced(),
                              n_layers=2, ardit_window_chunks=2)
    gen = torch.Generator().manual_seed(7)
    p_cpu = A.open_gates(A.init_params(cfg, gen, "cpu"), gen)
    p_gpu = params_to(p_cpu, DEV)
    tc = A.chunk_tokens(cfg)
    page = max(A.COND_TOKENS, tc)
    shape = (cfg.n_layers, 8, page, cfg.n_kv_heads, cfg.head_dim)
    kp = torch.randn(shape, generator=gen)
    vp = torch.randn(shape, generator=gen)
    chunk_idx = np.asarray([2, 1])
    tables = torch.tensor([[5, 1, 6], [2, 7, 3]], dtype=torch.int32)
    x = torch.randn((2, tc, A.LATENT_CH), generator=gen)
    t = torch.tensor([0.75, 0.0])
    dt = torch.tensor([0.25, 0.0])
    is_dn = torch.tensor([True, False])
    q_off = torch.as_tensor(A.COND_TOKENS + chunk_idx * tc,
                            dtype=torch.int32)
    ext = A.COND_TOKENS + 2 * tc

    def pages(window):
        m = A.batched_context_mask_multi(cfg, chunk_idx, np.asarray(window),
                                         np.zeros(2))[:, :ext]
        return torch.as_tensor(kvcache.mask_to_pages(
            m, 2, A.COND_TOKENS, tc, page))

    dn = pages([1, 2])
    dn[0, page:page + tc // 2] = False
    cl = pages([2, 2])
    worst = 0.0
    for name, masks in (("none", (None, None)), ("dn", (dn, None)),
                        ("dn+cl", (dn, cl))):
        args = (x, t, dt, kp, vp, tables, *masks, q_off, is_dn)
        x0, kv0 = A.denoise_step_paged(cfg, p_cpu, *args)
        x1, kv1 = A.denoise_step_paged(
            cfg, p_gpu, *(None if a is None else a.to(DEV) for a in args))
        sync()
        err = max(float((x1.cpu() - x0).abs().max()),
                  float((kv1["k"].cpu() - kv0["k"]).abs().max()),
                  float((kv1["v"].cpu() - kv0["v"]).abs().max()))
        worst = max(worst, err)
        print(f"  reduced denoise_step_paged [{name}] card vs CPU: "
              f"max |d| {err:.3g}")
        if not err <= 1e-4:
            raise AssertionError(f"integration [{name}] disagrees ({err})")
    return worst


def phase_session(counter):
    """Phase 4: the full-width main path through the public entry
    points; returns the kernel launch count of this run."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import ardit as A
    from repro_torch.sched_sim.metrics import summarize
    from repro_torch.serve.batcher import BatchedChunkExecutor
    from repro_torch.serve.session import (SessionConfig, StreamingSession,
                                           uniform_specs)

    cfg = get_config(SESSION_ARCH)
    n_streams, n_chunks = 3, 3
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    params = A.open_gates(A.init_params(cfg, gen, DEV), gen)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  params: {n_params / 1e9:.3f} B ({cfg.param_dtype}), "
          f"init {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    config = SessionConfig(model_cfg=cfg, executor="batched", max_batch=4,
                           pool_streams=n_streams + 1, device=DEV,
                           verbose=True)
    # the count starts here: everything below is the main path
    counter.launches = 0
    ex = BatchedChunkExecutor(cfg=cfg, params=params,
                              max_streams=config.pool_streams,
                              device=config.device)
    t0 = time.perf_counter()
    session = StreamingSession(config, executor=ex)
    handles = [session.submit(s) for s in uniform_specs(n_streams, n_chunks)]
    result = session.run()
    sync()
    wall = time.perf_counter() - t0
    launches = counter.launches

    summary = summarize(result)
    print(f"  real-batched full width: {summary.row()}")
    print(f"  session wall {wall:.2f} s (warm-up chunk included), "
          f"top-fidelity warm-up chunk {session.top_latency:.3f} s, "
          f"dispatches {ex.dispatch_count}, kernel launches {launches}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for key, lat in sorted(ex.latency_ema.items()):
        print(f"  chunk latency EMA {key}: {lat:.3f} s")
    for h in handles:
        r = h.record
        lats = [rt - st for rt, st in zip(r.ready_times, [r.arrival]
                                          + r.ready_times[:-1])]
        print(f"  stream {h.sid}: fidelities {h.fidelity_log}, "
              f"inter-chunk s {[round(v, 3) for v in lats]}")
        if not h.done or len(h.chunks) != n_chunks:
            raise AssertionError(f"stream {h.sid} got {len(h.chunks)} "
                                 f"of {n_chunks} chunks")
        for c in h.chunks:
            if tuple(c.shape) != (1, A.chunk_tokens(cfg), A.LATENT_CH) \
                    or not bool(torch.isfinite(c).all()):
                raise AssertionError(f"stream {h.sid}: bad latents")
    expected = cfg.n_layers * ex.dispatch_count
    if launches != expected or launches == 0:
        raise AssertionError(f"kernel launches {launches} != n_layers x "
                             f"dispatch_count = {expected}")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.paged_attention import ops
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build([ops.SOURCE])
    print(f"  built {ops.SOURCE.name} in {time.perf_counter() - t0:.1f} s")
    log = build.BUILD_LOGS.get(str(ops.SOURCE), "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
    if regs:
        print(f"  ptxas: {len(regs)} instantiations, {min(regs)}-{max(regs)} "
              f"registers per thread, {spills} bytes of spills")

    record = {"name": "paged_chunk_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/paged_attention/csrc/"
                        "paged_chunk_attention.cu",
              "replaces": "src/repro/kernels/paged_attention/kernel.py:197"}
    print("== phase 2: kernel vs plain version at full-width shapes")
    phase_kernel(record)
    print("== phase 3: reduced denoise step, card vs CPU")
    phase_integration()
    print("== phase 4: full-width ardit-self-forcing session")
    record["launches"] = phase_session(ops.paged_chunk_attention)

    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
