#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Card: name and power limit from nvidia-smi; build every CUDA kernel
   of the port from ``src/repro_torch/kernels/*/csrc`` with nvcc (five
   sources, one nvcc per source, started together).
2. Paged kernel vs plain version on the card at the batched path's
   full-width shapes (ardit-self-forcing: Sq = 2640, Hq = Hkv = 12, D =
   128, page = 2640, 8-entry tables): all-visible and explicit mask
   with drops / a hole row / a row that sees nothing, over bf16 and
   e4m3 pages, with and without the extent hint, GQA 4 (all on the
   tensor-core kernel), fp32 (the CUDA-core kernel); each case's path
   checked.  Times the kernel over bf16 and e4m3 pages, the plain
   version and one PyTorch library call computing the same attention,
   with the card's bound and the achieved TFLOP/s.
3. Flash kernel vs plain version on the card at the sequential path's
   full-width shapes (B = 1, Sq = 2640, 12 heads of 128, bf16,
   non-causal, Skv = sink + 0 / 3 / 7 chunks + the chunk) and in every
   mode at modest shapes (causal with q_offset, sink + window, the rho
   keep matrix, GQA, fp32, head dims 16 and 96); each case's kernel path
   (bf16 at D 96 / 128 on the tensor cores, the rest on the CUDA cores)
   checked, the tensor-core kernel's registers printed, the same
   timings with the kernel's and SDPA's TFLOP/s.
4. Integration at the reduced config, card vs CPU: the batched paged
   ``denoise_step_paged``, the sequential ``serve_chunk`` (fidelities
   top / rho 0.5 / W 3 / fp8 over a warm cache), the gather backend's
   ``denoise_step``, and the reduced ``mamba2-780m``'s ``prefill``
   (logits, conv and SSM states) and three ``decode_step``s.
5-7. The served paths at full width (random weights from a seed, adaLN
   gates opened), each with both kernels' launch counts set to 0 just
   before it and read just after: the batched paged session (3 streams
   x 3 chunks; paged launches = n_layers x dispatches, no flash
   launch), the sequential session (3 x 3; flash launches = n_layers x
   (steps + 1) per chunk, warm-up included, no paged launch) and the
   batched gather-backend session (2 x 2; flash launches = n_layers x
   unmasked steps, no paged launch); in phase 5 every paged launch, in
   phases 6 and 7 every flash launch must be a tensor-core launch.
8. SSD kernel vs plain version on the card at the full-width shape
   (mamba2-780m: B = 2, S = 32,768, 48 heads of 64, state 128, chunk
   128, bf16 x/B/C), a ragged S, S < chunk, an init_state, x/B/C as
   strided views with an init_state, a chained grid of 1,248 blocks
   (many more than are resident) with a ragged end and an init_state,
   a head count that leaves a partial head group, the reduced shape in
   fp32 and the reference tests' odd length and chunk (S = 33, chunk 8)
   at the reduced (P, N); each case's kernel path checked (bf16 at (64,
   128) on the tensor cores, the rest on the CUDA cores); the same
   timings (no library call computes the scan).
9. ``mamba2-780m`` at full width through the registry API (random bf16
   weights from a seed): ``prefill`` of 2 x 32,768 tokens, 32 greedy
   ``decode_step``s, a teacher-forced ``prefill`` over prompt +
   generated tokens whose last logits must match the last decode
   step's, and 16 ``decode_step``s at batch 128 from ``init_cache``;
   then the same prefill / decode / teacher-forced check with the
   weights widened to fp32 (2 x 8,192 tokens, 16 steps) at a limit for
   fp32 rounding; ssd_scan launches = 48 per prefill, none from decode;
   every bf16 prefill's launches on the tensor cores, the fp32 ones on
   the CUDA cores.
10. Elastic SP and migration at full width (run right after phase 7, on
   its weights): ``ardit-self-forcing`` in bf16 with two lanes on the
   one card.  (i) Direct apply: a stream with 2 chunks of context takes
   one SP2 step (``denoise_step_paged_sp``: home heads 0-5, donor heads
   6-11, each through a head-range view of its pool) against the SP1
   step on the same inputs; then batch-axis SP (the stream as a guest
   row beside the donor's own stream) against SP1; then one ``migrate``,
   whose pages must be bit-exact after the move.  (ii) Sessions: 2 lanes
   against 1 lane, 2 streams x 3 chunks under a static fidelity, one
   migration and one SP expand + release forced through the tick path;
   chunks compared.  Outputs must be bit-identical or, where a library
   GEMM's choice by batch size differs, within 1 bf16 ulp; every paged
   launch on the tensor cores.
11. Paged decode kernel vs plain version: the reference tests' shapes
   (fp32), q and pages of different dtypes (bf16 / fp32 q over e4m3,
   bf16 q over fp32, fp32 q over bf16) and minitron-8b's attention (Hq
   32, Hkv 8, D 128, bf16) at decode_32k (B = 128, 32,768 tokens in
   pages of 16 drawn from a shuffled pool of 262,144), all lengths full
   and lengths drawn from [1, 32768], then the pools in e4m3; the edges
   of the split: a stream one token past a unit boundary, B = 1 with
   32,768 tokens (128 units of 256), lengths 0 and 1 in one batch, D 64
   and pages of 8 and 64 tokens; the entry point's launches, both
   decode_32k launches on the tensor cores (split over the sequence);
   timings, the bound (visible K/V bytes) and SDPA over the
   pre-gathered context.
12. Scaled fp8 matmul kernel vs plain version: minitron-8b's FFN
   up-projection over one prefill_32k prompt (M 32,768, K 4,096, N
   16,384), the AR-DiT's FFN at 4 rows (M 10,560, K 1,536, N 8,960) and
   the reference tests' shapes (K 136 and N 300 on the CUDA cores, the
   rest on the tensor cores; the reference's own three at its criterion,
   |d| <= 1e-5 + 1e-5 |want| element by element, every other shape
   within 1e-5 of max |out|); all-positive operands at K = 4,096;
   ``quantize_fp8`` card vs CPU bit for bit; the entry point's launches,
   both FFN shapes on the tensor cores; timings, the bound at the fp8
   and at the bf16 rate and ``torch._scaled_mm`` with row-wise
   scales.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Without a CUDA device, or outside a checkout of the repository,
it exits non-zero and prints no result.
"""
import gc
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
# paged kernel vs plain version: both accumulate in fp32 (the limits of
# tests/test_torch_kernel_cuda.py): m within TOL_M, l within TOL_L_REL
# relative; the finalized output within TOL_O on the CUDA-core kernel
# (summation order only) and within PAGED_BF16_ULPS bf16 ulps at its
# largest magnitude on the tensor-core kernel, which rounds P to bf16
# before P V (as SDPA and the flash kernel do)
TOL_M, TOL_L_REL, TOL_O = 1e-4, 1e-4, 1e-4
PAGED_BF16_ULPS = 2
# paged_mha (bf16 output) vs SDPA over the same keys: outputs reach
# about 0.06, where a bf16 ulp is 2.4e-4; the limit is 8 ulps
TOL_SDPA = 2e-3
# flash kernel vs plain version: fp32 outputs within 1e-4; bf16 outputs
# within 2 bf16 ulps at the output's largest magnitude (both round one
# fp32 result that differs in summation order only)
TOL_FLASH_F32 = 1e-4
FLASH_BF16_ULPS = 2
# reduced-config steps and chunks, card vs CPU (fp32, TF32 off)
TOL_CARD_CPU = 1e-4
# SSD kernel vs plain version: y within SSD_BF16_ULPS bf16 ulps at its
# largest magnitude (bf16), or within 1e-4 of that magnitude (fp32, at
# least 1e-4 absolute; a scan's outputs grow with its inputs); the fp32
# final state within 1e-4 of its largest magnitude.  Both accumulate in
# fp32 and differ in summation order only.
SSD_BF16_ULPS = 2
TOL_SSD_F32 = 1e-4
# full-width mamba2-780m: the last decode step's logits against a
# teacher-forced prefill over the same tokens, as a relative L2 gap.  In
# bf16 the two paths round activations at different places in each of
# 48 layers (cuBLAS picks other kernels for 2 rows than for 65,536).
# The same weights widened to fp32 (2 x 8,192 tokens, 16 steps) give
# 1.4e-5 on an NVIDIA H100 80GB HBM3 (700 W), so the bf16 gap (4.5%
# there) is rounding; a state carried wrongly gives a gap of the order
# of the logits themselves (printed beside it: the gap to the logits of
# another position).  The bf16 limit separates only that; the fp32
# limit, 7x its reading, holds the two paths' arithmetic.
TOL_CONSISTENCY = 0.1
TOL_CONSISTENCY_F32 = 1e-4
SSM_F32_PREFILL, SSM_F32_STEPS = 8192, 16
SSM_ARCH = "mamba2-780m"
# prefill_32k's length with its batch of 32 cut to 2; decode_32k's batch
SSM_PREFILL = (2, 32768)
SSM_DECODE_STEPS = 32
SSM_WIDE_BATCH, SSM_WIDE_STEPS = 128, 16

DEV = "cuda"
# the main path's attention shapes at full width (ardit-self-forcing):
# chunk of 3 x 880 tokens, 12 heads of 128, one page per chunk, tables
# of the sink page + a 7-chunk ring, a sink of 77 conditioning tokens
KERNEL_SHAPES = dict(B=2, Sq=2640, H=12, D=128, page=2640, n=8, sink=77)
# the sequential path's attention at full width: one stream, the chunk's
# 2640 queries over sink + w chunks + the chunk itself
FLASH_SKV = (77 + 2640, 77 + 3 * 2640 + 2640, 77 + 7 * 2640 + 2640)
SESSION_ARCH = "ardit-self-forcing"
# the decode kernel at minitron-8b's decode_32k: batch, context, page,
# pool pages
DECODE_ARCH = "minitron-8b"
DECODE_SHAPE = dict(B=128, S=32768, page=16, pool=262144)
DECODE_PLAIN_ROWS = 16      # streams per plain-version call (memory)
# decode kernel vs plain: 1e-5 in fp32 (order of summation only); bf16
# outputs within 2 ulps at the largest magnitude (both round one fp32
# result); SDPA within 8 ulps
TOL_DECODE_F32 = 1e-5
DECODE_BF16_ULPS = 2
# fp8 kernel vs plain: products of e4m3 values are exact in fp32 and both
# kernels sum in fp32 (the tensor-core one on bf16 wgmma over e4m3
# widened exactly to bf16), in another order than the plain version: at
# the reference tests' shapes the reference's criterion, |d| <= TOL_FP8_REL
# + TOL_FP8_REL |want| element by element; elsewhere |d| <= TOL_FP8_REL of
# the output's largest magnitude
TOL_FP8_REL = 1e-5
FP8_REF_SHAPES = ((64, 64, 64), (128, 256, 64), (32, 32, 32))
FP8_SHAPES = {"minitron-8b FFN up, prefill_32k prompt": (32768, 4096, 16384),
              "ardit-self-forcing FFN, 4 rows": (10560, 1536, 8960)}


def sync():
    torch.cuda.synchronize()


def reset_counts(counters):
    """Sets every launch count (and tensor-core launch count) to 0."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "launches_tc"):
            fn.launches_tc = 0


def ptxas_entries(log):
    """(kernel name, registers, spill bytes) of each function in an nvcc
    -Xptxas=-v log, and the number of ptxas's "Potential Performance
    Loss" notes (wgmma serialization, C75xx)."""
    entries = []
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", block))
        entries.append((name, int(regs.group(1)) if regs else 0, spills))
    return entries, log.count("Potential Performance Loss")


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


def compare_partials(name, got, want, path="cuda_cores"):
    """Kernel partials against the plain version's on the same inputs:
    m within TOL_M, l within TOL_L_REL relative, the finalized output
    acc / l within TOL_O (``path`` "cuda_cores") or PAGED_BF16_ULPS bf16
    ulps at its largest magnitude ("wgmma"); rows that see nothing must
    be exactly (NEG_INF, 0, 0)."""
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
    o0 = finalize(m0, l0, acc0)
    err_o = float((finalize(m, l, acc) - o0).abs().max())
    tol_o = (PAGED_BF16_ULPS * ulp_bf16(float(o0.abs().max()))
             if path == "wgmma" else TOL_O)
    print(f"  {name} ({path}): |dm| {err_m:.3g} (limit {TOL_M:g})  |dl|/l "
          f"{err_l:.3g} (limit {TOL_L_REL:g})  |do| {err_o:.3g} "
          f"(limit {tol_o:.3g})")
    if not (err_m <= TOL_M and err_l <= TOL_L_REL and err_o <= tol_o):
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
    shapes, each case on the path ``kernel_path`` names; timings, the
    bound and SDPA for the all-visible main case with bf16 and e4m3
    pages."""
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.models.attention import paged_mha
    from repro_torch.models.kvcache import to_fp8_e4m3

    gen = torch.Generator(device=DEV).manual_seed(1234)
    B, Sq, H, D, page, n, sink = (KERNEL_SHAPES[k] for k in (
        "B", "Sq", "H", "D", "page", "n", "sink"))
    tc = page
    bf16 = torch.bfloat16
    errs = []
    fn = ops.paged_chunk_attention

    def run(name, q, kp, vp, table, mask, **hint):
        """One kernel call against the plain version; checks that it
        took kernel_path's kernel."""
        path = ops.kernel_path(q.dtype, kp.dtype, q.shape[-1],
                               q.shape[2] // kp.shape[2])
        before = fn.launches_tc
        got = fn(q, kp, vp, table, mask, **hint)
        if fn.launches_tc - before != int(path == "wgmma"):
            raise AssertionError(f"{name}: launch off its path {path}")
        errs.append(compare_partials(
            name, got, ref.paged_chunk_attention_ref(q, kp, vp, table, mask,
                                                     **hint), path))
        return path

    # (a) the main path's all-visible fast path: sink + 7 full ring pages
    q, kp, vp, table = paged_case(gen, B, Sq, H, H, D, page, n, bf16, bf16)
    hint = dict(sink=sink, chunk_tokens=tc)
    record["path"] = run("all-visible bf16", q, kp, vp, table, None, **hint)
    kf, vf = to_fp8_e4m3(kp), to_fp8_e4m3(vp)
    # (e) fp8-e4m3 pages under the same tables, all visible
    fp8_path = run("all-visible fp8 pages", q, kf, vf, table, None, **hint)
    reset_counts({"paged": fn})
    kernel_ms = cuda_ms(lambda: fn(q, kp, vp, table, None, **hint), 10)
    fp8_ms = cuda_ms(lambda: fn(q, kf, vf, table, None, **hint), 10)
    timed = (fn.launches, fn.launches_tc)
    plain_ms = cuda_ms(lambda: ref.paged_chunk_attention_ref(
        q, kp, vp, table, None, **hint), 3)
    fp8_plain_ms = cuda_ms(lambda: ref.paged_chunk_attention_ref(
        q, kf, vf, table, None, **hint), 3)

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
    # 4 * rows * D * visible tokens operations per (b, kv head), on the
    # bf16 tensor cores whatever the page dtype (e4m3 pages are widened)
    ctx = sink + (n - 1) * tc
    flops = 4.0 * B * H * Sq * D * ctx

    def bound(elt):
        nbytes = (q.numel() * q.element_size() + 2 * B * ctx * H * D * elt
                  + table.numel() * 4 + B * H * Sq * (D + 2) * 4)
        t_ops = flops / PEAK_FLOPS[str(bf16)] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes", nbytes)

    bound_ms, bound_by, nbytes = bound(2)
    fp8_bound, fp8_by, fp8_bytes = bound(1)
    print(f"  timed launches {timed[0]}, on the tensor cores {timed[1]} "
          f"(path {record['path']} for bf16 pages, {fp8_path} for e4m3)")
    print(f"  all-visible B={B} ctx={ctx}, bf16 pages: kernel "
          f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA "
          f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
          f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB), achieved "
          f"{flops / kernel_ms / 1e9:.2f} TFLOP/s")
    print(f"  all-visible B={B} ctx={ctx}, e4m3 pages: kernel {fp8_ms:.3f} "
          f"ms, plain {fp8_plain_ms:.3f} ms, bound {fp8_bound:.3f} ms "
          f"({fp8_by}; {fp8_bytes / 1e6:.1f} MB), achieved "
          f"{flops / fp8_ms / 1e9:.2f} TFLOP/s")
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
    run("masked bf16 (drops, hole, empty row)", q, kp, vp, table_b, mask,
        **hint)
    run("masked fp8 pages (drops, hole, empty row)", q, kf, vf, table_b,
        mask, **hint)
    # ... and the same mask without the extent hint (full pages)
    run("masked bf16, full pages", q, kp, vp, table_b, mask)
    del kf, vf, q, kp, vp

    # (c) GQA, group of 4, random token mask
    gq, gpage = max(8, Sq // 10), max(16, page // 5)
    q, kp, vp, table = paged_case(gen, 2, gq, 16, 4, D, gpage, 4, bf16,
                                  bf16)
    mask = torch.rand((2, 4 * gpage), generator=gen, device=DEV) < 0.6
    run("GQA G=4 masked", q, kp, vp, table, mask)

    # (d) fp32 queries and pages (the reduced configs' dtype), 3 entries
    q, kp, vp, table = paged_case(gen, B, Sq, H, H, D, page, 3,
                                  torch.float32, torch.float32)
    run("all-visible fp32", q, kp, vp, table, None, **hint)
    del q, kp, vp
    torch.cuda.empty_cache()

    record.update(max_abs_err=max(errs), ms=kernel_ms, kernel_ms=kernel_ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=library_ms)


def ulp_bf16(x):
    """The bf16 spacing at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(max(x, 1e-30))) - 7)


def compare_flash(name, got, want):
    """Flash kernel output against the plain version's on the same
    inputs, within TOL_FLASH_F32 (fp32) or FLASH_BF16_ULPS bf16 ulps at
    the output's largest magnitude (bf16)."""
    err = float((got.float() - want.float()).abs().max())
    if want.dtype == torch.float32:
        limit = TOL_FLASH_F32
    else:
        limit = FLASH_BF16_ULPS * ulp_bf16(float(want.float().abs().max()))
    print(f"  {name}: |d| {err:.3g} (limit {limit:.3g})")
    if not err <= limit or got.shape != want.shape \
            or got.dtype != want.dtype:
        raise AssertionError(f"{name}: flash kernel disagrees with the "
                             f"plain version ({err} > {limit})")
    return err


def phase_flash(record):
    """Phase 3: the flash kernel against its plain version at the
    sequential path's shapes and in every mode; timings and the bound of
    the deepest shape."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=DEV).manual_seed(4321)
    bf16 = torch.bfloat16

    def qkv(B, Sq, Skv, Hq, Hkv, D, dtype):
        return tuple(torch.randn(s, generator=gen, device=DEV).to(dtype)
                     for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                               (B, Skv, Hkv, D)))

    def launch(q, k, v, **kw):
        """One kernel call; checks that it took kernel_path's kernel."""
        path = ops.kernel_path(q.dtype, q.shape[-1])
        before = ops.flash_mha.launches_tc
        out = ops.flash_mha(q, k, v, **kw)
        if ops.flash_mha.launches_tc - before != int(path == "wgmma"):
            raise AssertionError(f"flash launch off its path {path}")
        return out, path

    entries, _ = ptxas_entries(build.BUILD_LOGS.get(str(ops.SOURCE), ""))
    tc_regs = {re.search(r"ILi(\d+)E", name).group(1): regs
               for name, regs, _ in entries if "wgmma" in name}
    print(f"  tensor-core kernel registers per thread at launch, by head "
          f"dim: {tc_regs or 'not in this build log'} (setmaxnreg then "
          f"gives the consumer warpgroups 232, the producer 40)")

    errs = []
    B, Sq, H, D = 1, 2640, 12, 128
    for skv in FLASH_SKV:
        q, k, v = qkv(B, Sq, skv, H, H, D, bf16)

        def kern():
            return ops.flash_mha(q, k, v, n_kv_heads=H, causal=False)

        def plain():
            return ref.flash_mha_ref(q, k, v, n_kv_heads=H, causal=False)

        out, path = launch(q, k, v, n_kv_heads=H, causal=False)
        errs.append(compare_flash(f"non-causal bf16 Skv={skv}", out,
                                  plain()))
        kernel_ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 3)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt)

        library_ms = cuda_ms(library, 10)
        lib_err = float((out.float() - library().transpose(1, 2).float())
                        .abs().max())
        lib_limit = 8 * ulp_bf16(float(out.float().abs().max()))
        print(f"  kernel vs SDPA: |d| {lib_err:.3g} (limit {lib_limit:.3g})")
        if not lib_err <= lib_limit:
            raise AssertionError(f"flash kernel disagrees with SDPA "
                                 f"({lib_err})")
        # each input read once, the output written once; 4 * Sq * Skv *
        # D operations per (b, head)
        flops = 4.0 * B * H * Sq * skv * D
        nbytes = 2 * q.numel() * q.element_size() \
            + 2 * k.numel() * k.element_size()
        t_ops = flops / PEAK_FLOPS[str(q.dtype)] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"  B={B} Sq={Sq} Skv={skv}: kernel ({path}) {kernel_ms:.3f} "
              f"ms, {flops / kernel_ms / 1e9:.2f} TFLOP/s; SDPA "
              f"{library_ms:.3f} ms, {flops / library_ms / 1e9:.2f} "
              f"TFLOP/s; plain {plain_ms:.3f} ms; bound {bound_ms:.3f} ms "
              f"({bound_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} "
              f"MB)")
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()
    # the record keeps the deepest shape's numbers
    record.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=library_ms)

    # every mode at a modest shape: (name, B, Sq, Skv, Hq, Hkv, D, dtype,
    # keyword arguments); the rho blocks are not the kernels' tiles
    f32 = torch.float32
    cases = [
        ("causal q_offset bf16", 2, 512, 1536, 12, 12, 128, bf16,
         dict(q_offset=1024)),
        ("sink + window bf16", 1, 1024, 1024, 12, 12, 128, bf16,
         dict(window=256, sink=77)),
        ("rho 0.7 keep matrix 96 x 160 bf16", 1, 1920, 1920, 12, 12, 128,
         bf16, dict(sparsity=0.7, block_q=96, block_kv=160)),
        ("GQA G=4 non-causal bf16", 2, 700, 1800, 16, 4, 128, bf16,
         dict(causal=False)),
        ("non-causal fp32", 1, 640, 2717, 12, 12, 128, f32,
         dict(causal=False)),
        ("D=16 non-causal fp32 (reduced)", 2, 48, 269, 4, 4, 16, f32,
         dict(causal=False)),
        ("D=16 sink + window fp32", 1, 256, 256, 4, 4, 16, f32,
         dict(window=64, sink=16)),
        ("D=96 non-causal bf16 (causal-forcing)", 1, 660, 2057, 16, 16, 96,
         bf16, dict(causal=False)),
        ("D=96 sink + window bf16", 1, 1024, 1024, 16, 16, 96, bf16,
         dict(window=300, sink=77)),
        ("D=96 rho 0.5 bf16", 1, 768, 768, 16, 16, 96, bf16,
         dict(sparsity=0.5, block_q=96, block_kv=64)),
        ("D=96 causal rho 0.5 fp32", 1, 512, 512, 16, 16, 96, f32,
         dict(sparsity=0.5, block_q=64, block_kv=128)),
    ]
    for name, b_, sq, skv, hq, hkv, d, dt, kw in cases:
        q, k, v = qkv(b_, sq, skv, hq, hkv, d, dt)
        kw = {**dict(block_q=128, block_kv=128), **kw}
        out, path = launch(q, k, v, n_kv_heads=hkv, **kw)
        errs.append(compare_flash(
            f"{name} ({path})", out,
            ref.flash_mha_ref(q, k, v, n_kv_heads=hkv, **kw)))
    del q, k, v
    torch.cuda.empty_cache()
    record["max_abs_err"] = max(errs)


def phase_integration():
    """Phase 4: the reduced config on the card (kernels) and on the CPU
    (plain versions), same params and inputs: the batched paged step
    (masks None / denoise / denoise + clean), the gather backend's step
    (the same masks) and the sequential ``serve_chunk`` at four
    fidelities.  fp32 throughout, TF32 off: agreement within 1e-4."""
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
        if not err <= TOL_CARD_CPU:
            raise AssertionError(f"integration [{name}] disagrees ({err})")

    # the gather backend's step over a contiguous context: masks none
    # (the flash kernel on the card) / denoise / denoise + clean (the
    # plain masked segment on both devices)
    ctx = A.COND_TOKENS + 2 * tc
    cshape = (cfg.n_layers, 2, ctx, cfg.n_kv_heads, cfg.head_dim)
    ck = torch.randn(cshape, generator=gen)
    cv = torch.randn(cshape, generator=gen)
    dn = torch.rand((2, ctx), generator=gen) < 0.6
    cl = torch.rand((2, ctx), generator=gen) < 0.8
    for name, masks in (("none", (None, None)), ("dn", (dn, None)),
                        ("dn+cl", (dn, cl))):
        args = (x, t, dt, ck, cv, q_off, *masks, is_dn)
        x0, kv0 = A.denoise_step(cfg, p_cpu, *args)
        x1, kv1 = A.denoise_step(
            cfg, p_gpu, *(None if a is None else a.to(DEV) for a in args))
        sync()
        err = max(float((x1.cpu() - x0).abs().max()),
                  float((kv1["k"].cpu() - kv0["k"]).abs().max()))
        worst = max(worst, err)
        print(f"  reduced denoise_step (gather) [{name}] card vs CPU: "
              f"max |d| {err:.3g} (limit {TOL_CARD_CPU:g})")
        if not err <= TOL_CARD_CPU:
            raise AssertionError(f"gather step [{name}] disagrees ({err})")

    # the sequential path: a cache warmed by 8 chunks (a full window,
    # long enough for rho to drop cached tokens), then one chunk at each
    # fidelity, from the same cache on both devices
    cfg8 = dataclasses.replace(cfg, ardit_window_chunks=8)
    cond = torch.randn((1, A.COND_TOKENS, cfg.d_model), generator=gen) * .02
    caches = {"cpu": A.init_cache(cfg8, p_cpu, cond),
              DEV: A.init_cache(cfg8, p_gpu, cond.to(DEV))}
    params = {"cpu": p_cpu, DEV: p_gpu}
    warm = A.FidelityConfig(2, 0.0, 8, "bf16")
    for _ in range(8):
        noise = torch.randn((1, tc, A.LATENT_CH), generator=gen)
        for d in caches:
            _, caches[d] = A.serve_chunk(cfg8, params[d], caches[d],
                                         noise.to(d), warm)
    noise = torch.randn((1, tc, A.LATENT_CH), generator=gen)
    for fid in (A.HIGHEST_QUALITY, A.FidelityConfig(2, 0.5, 8, "bf16"),
                A.FidelityConfig(3, 0.0, 3, "bf16"),
                A.FidelityConfig(2, 0.0, 8, "fp8")):
        x0, c0 = A.serve_chunk(cfg8, p_cpu, caches["cpu"], noise, fid)
        x1, c1 = A.serve_chunk(cfg8, p_gpu, caches[DEV], noise.to(DEV), fid)
        sync()
        err = float((x1.cpu() - x0).abs().max())
        if fid.quant != "fp8":     # fp8 KV may round to a neighbour
            err = max(err, float((c1["k"].cpu() - c0["k"]).abs().max()),
                      float((c1["v"].cpu() - c0["v"]).abs().max()))
        worst = max(worst, err)
        print(f"  reduced serve_chunk [{fid.key}] card vs CPU: max |d| "
              f"{err:.3g} (limit {TOL_CARD_CPU:g})")
        if not err <= TOL_CARD_CPU:
            raise AssertionError(f"serve_chunk [{fid.key}] disagrees "
                                 f"({err})")
    return max(worst, phase_integration_ssm())


def phase_integration_ssm():
    """The reduced ``mamba2-780m`` (fp32) through the registry API on
    the card (the SSD kernel) and on the CPU (its plain version), with
    weights from one CPU init: ``prefill`` over a ragged 100 tokens
    (logits, conv and SSM states), then three ``decode_step``s fed the
    CPU's greedy tokens on both devices."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry, ssm
    from repro_torch.models.convert import params_to

    cfg = get_config(SSM_ARCH).reduced()
    api = registry.get_api(cfg)
    gen = torch.Generator().manual_seed(11)
    p_cpu = ssm.init_params(cfg, gen, "cpu")
    p_gpu = params_to(p_cpu, DEV)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen)
    out = {"cpu": api.prefill(cfg, p_cpu, tokens),
           DEV: api.prefill(cfg, p_gpu, tokens.to(DEV))}
    worst = 0.0
    for step in range(4):
        (l0, s0, pos0), (l1, s1, pos1) = out["cpu"], out[DEV]
        sync()
        err = max(float((l1.cpu() - l0).abs().max()),
                  float((s1["conv"].cpu() - s0["conv"]).abs().max()),
                  float((s1["ssm"].cpu() - s0["ssm"]).abs().max()))
        worst = max(worst, err)
        name = "prefill" if step == 0 else f"decode_step {step}"
        print(f"  reduced {SSM_ARCH} {name} card vs CPU (logits, conv and "
              f"SSM states): max |d| {err:.3g} (limit {TOL_CARD_CPU:g})")
        if not err <= TOL_CARD_CPU:
            raise AssertionError(f"{SSM_ARCH} {name} disagrees ({err})")
        if step == 3:
            break
        nxt = l0[:, :cfg.vocab_size].argmax(-1)[:, None]
        l0, s0 = api.decode_step(cfg, p_cpu, s0, nxt, pos0)
        l1, s1 = api.decode_step(cfg, p_gpu, s1, nxt.to(DEV), pos1)
        out = {"cpu": (l0, s0, pos0 + 1), DEV: (l1, s1, pos1 + 1)}
    return worst


def full_width_params():
    """``ardit-self-forcing`` at full width: random weights from seed 0
    with the adaLN gates opened, on the card (shared by phases 5-7)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import ardit as A

    cfg = get_config(SESSION_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    params = A.open_gates(A.init_params(cfg, gen, DEV), gen)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  params: {n_params / 1e9:.3f} B ({cfg.param_dtype}), "
          f"init {time.perf_counter() - t0:.1f} s")
    return cfg, params


def run_session(label, cfg, make_executor, config, n_streams, n_chunks,
                counters):
    """Serve ``n_streams`` x ``n_chunks`` at t = 0 through
    ``StreamingSession`` with the executor ``make_executor()``; every
    launch count in ``counters`` is set to 0 just before and read just
    after.  Checks every stream's latents; returns (executor, session,
    launch counts by kernel name)."""
    from repro_torch.models import ardit as A
    from repro_torch.sched_sim.metrics import summarize
    from repro_torch.serve.session import StreamingSession, uniform_specs

    # the previous session's executor and pool sit in reference cycles
    # (session <-> handles): collect them so the peak is this path's own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    ex = make_executor()
    t0 = time.perf_counter()
    session = StreamingSession(config, executor=ex)
    handles = [session.submit(s) for s in uniform_specs(n_streams, n_chunks)]
    result = session.run()
    sync()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    launches_tc = counters["flash_mha"].launches_tc

    print(f"  {label} full width: {summarize(result).row()}")
    print(f"  session wall {wall:.2f} s (warm-up chunk included), "
          f"top-fidelity warm-up chunk {session.top_latency:.3f} s, "
          f"kernel launches {launches} (flash on the tensor cores: "
          f"{launches_tc}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    if launches_tc != launches["flash_mha"]:
        raise AssertionError(f"{label}: {launches['flash_mha']} flash "
                             f"launches, {launches_tc} on the tensor cores")
    return ex, session, launches


def phase_batched(cfg, params, counters):
    """Phase 5: the batched paged path (3 streams x 3 chunks): paged
    launches = n_layers x dispatches, no flash launch."""
    from repro_torch.serve.batcher import BatchedChunkExecutor
    from repro_torch.serve.session import SessionConfig

    config = SessionConfig(model_cfg=cfg, executor="batched", max_batch=4,
                           pool_streams=4, device=DEV, verbose=True)
    ex, _, launches = run_session(
        "real-batched (paged)", cfg,
        lambda: BatchedChunkExecutor(cfg=cfg, params=params,
                                     max_streams=config.pool_streams,
                                     device=config.device),
        config, 3, 3, counters)
    expected = cfg.n_layers * ex.dispatch_count
    paged_tc = counters["paged_chunk_attention"].launches_tc
    print(f"  dispatches {ex.dispatch_count}; paged launches on the tensor "
          f"cores {paged_tc}")
    if launches["paged_chunk_attention"] != expected or expected == 0 \
            or launches["flash_mha"] != 0:
        raise AssertionError(f"launches {launches}: expected {expected} "
                             f"paged (n_layers x dispatches), 0 flash")
    if paged_tc != expected:
        raise AssertionError(f"{expected} bf16 paged launches, {paged_tc} "
                             f"on the tensor cores")
    return launches["paged_chunk_attention"]


def phase_sequential(cfg, params, counters):
    """Phase 6: the sequential path (3 streams x 3 chunks, whole chunks
    one stream at a time): flash launches = n_layers x (steps + 1) per
    chunk, warm-up included; no paged launch."""
    from repro_torch.models import ardit as A
    from repro_torch.serve.executor import SequentialChunkExecutor
    from repro_torch.serve.session import SessionConfig

    config = SessionConfig(model_cfg=cfg, executor="sequential", device=DEV,
                           verbose=True)
    ex, session, launches = run_session(
        "real-sequential", cfg,
        lambda: SequentialChunkExecutor(cfg=cfg, params=params,
                                        device=DEV),
        config, 3, 3, counters)
    steps = {f"S{s}": s for s in (2, 3, 4)}
    forwards = A.HIGHEST_QUALITY.steps + 1 + sum(
        (steps[key.split("_")[0]] + 1) * n
        for key, n in session.fidelity_counts.items())
    expected = cfg.n_layers * forwards
    print(f"  forwards {forwards} (warm-up chunk included)")
    if launches["flash_mha"] != expected or launches[
            "paged_chunk_attention"] != 0:
        raise AssertionError(f"launches {launches}: expected {expected} "
                             f"flash (n_layers x forwards), 0 paged")
    return launches["flash_mha"]


def phase_gather(cfg, params, counters):
    """Phase 7: the batched gather backend (2 streams x 2 chunks,
    max_batch 2): steps whose context is all visible take the flash
    kernel (n_layers launches each), the others the plain masked
    segment; no paged launch."""
    from repro_torch.serve.batcher import BatchedChunkExecutor
    from repro_torch.serve.session import SessionConfig

    config = SessionConfig(model_cfg=cfg, executor="batched", max_batch=2,
                           pool_streams=3, context_backend="gather",
                           device=DEV, verbose=True)
    ex, _, launches = run_session(
        "real-batched (gather)", cfg,
        lambda: BatchedChunkExecutor(cfg=cfg, params=params,
                                     max_streams=config.pool_streams,
                                     context_backend="gather", device=DEV),
        config, 2, 2, counters)
    flash = launches["flash_mha"]
    kernel_steps, rest = divmod(flash, cfg.n_layers)
    print(f"  dispatches {ex.dispatch_count}: {kernel_steps} through the "
          f"flash kernel, {ex.dispatch_count - kernel_steps} through the "
          f"masked direct path")
    if rest or flash == 0 or kernel_steps > ex.dispatch_count \
            or launches["paged_chunk_attention"] != 0:
        raise AssertionError(f"launches {launches} for "
                             f"{ex.dispatch_count} dispatches")
    return flash


def ssd_case(gen, B, S, H, P, N, dtype, init=False, view=False):
    """SSD inputs on the card from the device generator ``gen``, scaled
    like the model's: dt = softplus(normal - 3) (mostly 1e-3-0.3), A =
    -(1..H) (``A_log`` = log(1..H) at init); with ``view``, x/B/C are
    slices of one [B, S, H*P + 2N] tensor, as the model passes them."""
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen,
                      device=DEV).to(dtype)
    xi, Bp, Cp = torch.split(xbc, [H * P, N, N], dim=-1)
    x, Bm, Cm = xi.reshape(B, S, H, P), Bp.reshape(B, S, 1, N), \
        Cp.reshape(B, S, 1, N)
    if not view:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device=DEV) - 3.0)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=DEV)
    s0 = torch.randn((B, H, P, N), generator=gen, device=DEV) if init \
        else None
    return x, dt, A, Bm, Cm, s0


def compare_ssd(name, got, want):
    """SSD kernel (y, final state) against the plain version's: y within
    SSD_BF16_ULPS bf16 ulps (bf16) or TOL_SSD_F32 relative (fp32) at its
    largest magnitude, the final state within TOL_SSD_F32 relative."""
    (y, f), (y0, f0) = got, want
    top = float(y0.float().abs().max())
    if y0.dtype == torch.float32:
        limit = TOL_SSD_F32 * max(1.0, top)
    else:
        limit = SSD_BF16_ULPS * ulp_bf16(top)
    f_limit = TOL_SSD_F32 * max(1.0, float(f0.abs().max()))
    err = float((y.float() - y0.float()).abs().max())
    f_err = float((f - f0).abs().max())
    print(f"  {name}: y |d| {err:.3g} (limit {limit:.3g}, |y| <= {top:.3g})"
          f"  state |d| {f_err:.3g} (limit {f_limit:.3g})")
    if not (err <= limit and f_err <= f_limit) or y.shape != y0.shape \
            or y.dtype != y0.dtype or f.shape != f0.shape \
            or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{name}: ssd kernel disagrees with the plain "
                             f"version (y {err}, state {f_err})")
    return err


def ssd_flops(B, S, H, P, N, chunk):
    """Operations the SSD scan needs, chunk by chunk (a ragged last chunk
    of l rows counts l): per (b, chunk) the lower triangle of C B^T,
    l(l+1)N (B and C are shared by the heads, G = 1); per (b, h, chunk)
    the triangle of W X, l(l+1)P, the inter-chunk output C @ state^T,
    2lNP, and the chunk state B^T X, 2lNP.  The exps and the cumsum
    (~l^2/2 per head) are left out: under 1% of these."""
    q = min(chunk, S)
    lengths = [q] * (S // q) + ([S % q] if S % q else [])
    return float(B * sum(l * (l + 1) * N
                         + H * (l * (l + 1) * P + 4 * l * N * P)
                         for l in lengths))


def phase_ssd(record):
    """Phase 8: the SSD kernel against its plain version at the
    full-width shape and the listed others; timings and the bound of the
    full-width shape."""
    from repro_torch.kernels.ssd_scan import ops, ref

    gen = torch.Generator(device=DEV).manual_seed(2468)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S = SSM_PREFILL
    H, P, N, Q = 48, 64, 128, 128
    x, dt, A, Bm, Cm, _ = ssd_case(gen, B, S, H, P, N, bf16)

    def kern():
        return ops.ssd(x, dt, A, Bm, Cm, chunk=Q)

    def plain():
        return ref.ssd_ref(x, dt, A, Bm, Cm, chunk=Q)

    def on_path(name, fn, want_path):
        """fn()'s launch, checked to have taken ``want_path``."""
        before = (ops.ssd.launches, ops.ssd.launches_tc)
        out = fn()
        sync()
        tc = ops.ssd.launches_tc - before[1]
        path = "wgmma" if tc else "cuda_cores"
        if ops.ssd.launches - before[0] != 1 or path != want_path:
            raise AssertionError(f"{name}: launched on {path}, expected "
                                 f"{want_path}")
        return out

    errs = [compare_ssd(f"full width B={B} S={S} bf16 (wgmma)",
                        on_path("full width", kern, "wgmma"), plain())]
    kernel_ms = cuda_ms(kern, 10)
    plain_ms = cuda_ms(plain, 2)
    # each input read once (x, dt, A, B, C), y and the final state
    # written once; the operations the function needs (ssd_flops)
    flops = ssd_flops(B, S, H, P, N, Q)
    nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4 + H * 4
              + 2 * Bm.numel() * Bm.element_size() + B * H * P * N * 4)
    t_ops = flops / PEAK_FLOPS[str(x.dtype)] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"  B={B} S={S} H={H} P={P} N={N} Q={Q}: kernel {kernel_ms:.3f} "
          f"ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
          f"achieved {flops / kernel_ms / 1e9:.2f} TFLOP/s")
    print("  library: none (no single PyTorch call computes the SSD scan)")
    del x, dt, A, Bm, Cm
    torch.cuda.empty_cache()
    record.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=None)

    # (name, B, S, H, P, N, chunk, dtype, init_state, strided views)
    cases = [
        ("ragged S=1000 bf16", 2, 1000, H, P, N, Q, bf16, False, False),
        ("S=100 < chunk bf16", 2, 100, H, P, N, Q, bf16, False, False),
        ("init_state S=1000 bf16", 2, 1000, H, P, N, Q, bf16, True, False),
        ("strided views with init_state S=1000 bf16", 2, 1000, H, P, N, Q,
         bf16, True, True),
        ("chained grid of 1,248 blocks B=2 S=13,243 bf16", 2, 13243, H, P,
         N, Q, bf16, True, True),
        ("partial head group H=7 chunk 64 bf16", 2, 1000, 7, P, N, 64,
         bf16, False, True),
        ("reduced S=1000 fp32 (P 16, N 16, chunk 16)", 2, 1000, 8, 16, 16,
         16, f32, True, False),
        ("odd B=2 S=33 H=3 chunk 8 fp32 (P 16, N 16)", 2, 33, 3, 16, 16,
         8, f32, True, False),
    ]
    for name, b_, s_, h_, p_, n_, q_, dtype, init, view in cases:
        x, dt, A, Bm, Cm, s0 = ssd_case(gen, b_, s_, h_, p_, n_, dtype,
                                        init, view)
        path = ops.kernel_path(dtype, p_, n_)
        errs.append(compare_ssd(
            f"{name} ({path})",
            on_path(name, lambda: ops.ssd(x, dt, A, Bm, Cm, chunk=q_,
                                          init_state=s0), path),
            ref.ssd_ref(x.contiguous(), dt, A, Bm.contiguous(),
                        Cm.contiguous(), chunk=q_, init_state=s0)))
    record["max_abs_err"] = max(errs)


def phase_ssm(counters):
    """Phase 9: ``mamba2-780m`` at full width through the registry API.
    Every launch count is set to 0 just before and read after each
    step: ssd_scan launches = n_layers per prefill, none from decode,
    no attention launch."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import registry

    cfg = get_config(SSM_ARCH)
    api = registry.get_api(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    params = api.init(cfg, gen, DEV)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  params: {n_params / 1e9:.3f} B ({cfg.param_dtype}), init "
          f"{time.perf_counter() - t0:.1f} s")
    B, S = SSM_PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(DEV)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    prefills = prefills_bf16 = 0

    def check(label):
        """Launch counts: n_layers ssd launches per prefill, nothing else;
        the bf16 prefills' launches on the tensor cores, the fp32 ones'
        on the CUDA cores."""
        launches = {name: fn.launches for name, fn in counters.items()}
        want = {**{k: 0 for k in counters}, "ssd": prefills * cfg.n_layers}
        tc = counters["ssd"].launches_tc
        if launches != want or tc != prefills_bf16 * cfg.n_layers:
            raise AssertionError(f"{label}: launches {launches}, "
                                 f"{tc} on the tensor cores; expected "
                                 f"{want}, {prefills_bf16 * cfg.n_layers}")

    def greedy(logits):
        return logits[:, :cfg.vocab_size].argmax(-1)[:, None]

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def consistency(label, cfg_, params_, prompt, steps, limit):
        """prefill, ``steps`` greedy decode steps, then a teacher-forced
        prefill over prompt + generated tokens: its last logits against
        the last decode step's, as a relative L2 gap within ``limit``."""
        nonlocal prefills, prefills_bf16
        b, s = prompt.shape
        bf16 = cfg_.param_dtype == "bfloat16"
        sync()
        t0 = time.perf_counter()
        logits, state, pos = api.prefill(cfg_, params_, prompt)
        sync()
        prefill_s = time.perf_counter() - t0
        prefills += 1
        prefills_bf16 += bf16
        check(f"{label} prefill")
        if tuple(logits.shape) != (b, cfg.padded_vocab) \
                or not bool(torch.isfinite(logits).all()) \
                or not all(bool(torch.isfinite(v).all())
                           for v in state.values()):
            raise AssertionError(f"{label} prefill: bad logits or state")
        print(f"  {label} prefill B={b} S={s}: {prefill_s:.3f} s "
              f"({b * s / prefill_s:.0f} tokens/s), state conv "
              f"{tuple(state['conv'].shape)} ssm {tuple(state['ssm'].shape)}")
        first_logits = logits
        generated = []
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = greedy(logits)
            generated.append(tok)
            logits, state = api.decode_step(cfg_, params_, state, tok, pos)
            pos = pos + 1
        sync()
        decode_ms = (time.perf_counter() - t0) / steps * 1e3
        check(f"{label} decode")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{label} decode: non-finite logits")
        print(f"  {label} decode B={b}: {steps} greedy steps, "
              f"{decode_ms:.2f} ms per token (step)")
        ext = torch.cat([prompt] + generated, 1)
        sync()
        t0 = time.perf_counter()
        tf_logits, _, _ = api.prefill(cfg_, params_, ext)
        sync()
        tf_s = time.perf_counter() - t0
        prefills += 1
        prefills_bf16 += bf16
        check(f"{label} teacher-forced prefill")
        gap = rel(logits, tf_logits)
        max_d = float((logits.float() - tf_logits.float()).abs().max())
        agree = float((greedy(logits) == greedy(tf_logits)).float().mean())
        print(f"  {label} teacher-forced prefill S={ext.shape[1]} "
              f"({tf_s:.3f} s): last decode logits vs it: relative L2 "
              f"{gap:.4g} (limit {limit:g}), max |d| {max_d:.4g} at "
              f"|logits| <= {float(tf_logits.float().abs().max()):.4g}, "
              f"greedy token agrees for {agree:.0%} of rows; the prefill's "
              f"own last logits (another position) vs it: relative L2 "
              f"{rel(first_logits, tf_logits):.4g}")
        if not gap <= limit:
            raise AssertionError(f"full-width {label} prefill/decode gap "
                                 f"{gap}")

    consistency(cfg.param_dtype, cfg, params, tokens, SSM_DECODE_STEPS,
                TOL_CONSISTENCY)
    prefill_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    wide = api.init_cache(cfg, SSM_WIDE_BATCH, S, device=DEV)
    tok = torch.randint(0, cfg.vocab_size, (SSM_WIDE_BATCH, 1),
                        generator=gen).to(DEV)
    pos = torch.zeros((SSM_WIDE_BATCH,), dtype=torch.int32, device=DEV)
    step_ms = []
    for _ in range(SSM_WIDE_STEPS):
        sync()
        t0 = time.perf_counter()
        logits, wide = api.decode_step(cfg, params, wide, tok, pos)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        tok, pos = greedy(logits), pos + 1
    check("batch-128 decode")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("batch-128 decode: non-finite logits")
    rest = step_ms[1:]
    print(f"  decode B={SSM_WIDE_BATCH} from init_cache: {SSM_WIDE_STEPS} "
          f"steps, first {step_ms[0]:.2f} ms, then {sum(rest) / len(rest):.2f}"
          f" ms per token (step), state {wide['ssm'].numel() * 4 / 2**30:.2f}"
          f" GiB fp32 SSM + conv")
    wide_peak = torch.cuda.max_memory_allocated()
    del wide, logits
    gc.collect()
    torch.cuda.empty_cache()

    # the same weights widened to fp32, a shorter prompt: both paths
    # then differ in fp32 summation order only
    consistency("float32", dataclasses.replace(cfg, param_dtype="float32"),
                L.tree_map(lambda t: t.float(), params),
                tokens[:, :SSM_F32_PREFILL], SSM_F32_STEPS,
                TOL_CONSISTENCY_F32)
    print(f"  ssd_scan launches {counters['ssd'].launches} = {cfg.n_layers} x "
          f"{prefills} prefills ({counters['ssd'].launches_tc} on the tensor "
          f"cores: the {prefills_bf16} bf16 prefills), 0 from "
          f"{SSM_DECODE_STEPS + SSM_WIDE_STEPS + SSM_F32_STEPS} decode steps;"
          f" peak memory {prefill_peak / 2**30:.2f} GiB ({cfg.param_dtype} "
          f"prefill and "
          f"B={B} decode), {wide_peak / 2**30:.2f} GiB (B={SSM_WIDE_BATCH} "
          f"decode)")
    return counters["ssd"].launches


def same_or_ulp(name, got, want):
    """``got`` against ``want``: bit-identical, or within 1 bf16 ulp at
    ``want``'s largest magnitude (a library GEMM may pick another kernel
    for another batch size); returns |d|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    if torch.equal(got, want):
        print(f"  {name}: bit-identical")
        return 0.0
    err = float((got.float() - want.float()).abs().max())
    limit = ulp_bf16(float(want.float().abs().max()))
    print(f"  {name}: |d| {err:.3g} (not bit-identical; limit 1 bf16 ulp "
          f"= {limit:.3g})")
    if not err <= limit:
        raise AssertionError(f"{name}: {err} > {limit}")
    return err


def phase_lanes(cfg, params, counters):
    """Phase 10: elastic SP and migration at full width, two lanes on
    the one card; see the module docstring."""
    from repro_torch.core.bmpr import StaticFidelity
    from repro_torch.core.elastic_sp import SPDecision
    from repro_torch.core.fidelity import FidelityConfig
    from repro_torch.core.rehoming import Migration
    from repro_torch.models import ardit as A
    from repro_torch.serve.lanes import LanePool
    from repro_torch.serve.session import (SessionConfig, StreamingSession,
                                           uniform_specs)

    paged = counters["paged_chunk_attention"]
    fid = FidelityConfig(2, 0.0, 7, "bf16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def reset():
        reset_counts(counters)
        paged.view_launches = 0

    def launches():
        return {**{k: fn.launches for k, fn in counters.items()},
                "paged_chunk_attention (head-range views)":
                    paged.view_launches,
                "paged_chunk_attention (tensor cores)": paged.launches_tc}

    def all_tc(got, what):
        """Every paged launch of a bf16 run went to the tensor cores."""
        if got["paged_chunk_attention (tensor cores)"] != \
                got["paged_chunk_attention"]:
            raise AssertionError(f"{what}: paged launches off the tensor "
                                 f"cores {got}")

    def chunks(ex, sid, n):
        for _ in range(n):
            ex.begin_chunk(sid, fid, 0.0)
            while sid in ex.inflight:
                ex.run_step([sid])

    # ---- (i) direct apply -------------------------------------------------
    lanes = LanePool(2, cfg=cfg, params=params, max_streams=2, device=DEV)
    home, donor = lanes.ex(0), lanes.ex(1)
    lanes.admit(0, 0, seed=0)
    lanes.admit(1, 1, seed=1)
    chunks(home, 0, 2)
    chunks(donor, 1, 2)
    tc, n_ring, L = A.chunk_tokens(cfg), 2, cfg.n_layers
    gen = torch.Generator().manual_seed(10)
    x = torch.randn((2, tc, A.LATENT_CH), generator=gen).to(DEV)
    t = torch.full((2,), 0.5, device=DEV)
    q_off = torch.full((2,), A.COND_TOKENS + n_ring * tc, dtype=torch.int32,
                       device=DEV)
    is_dn = torch.ones((2,), dtype=torch.bool, device=DEV)
    tables = home.pool.tables_for([0])[:, :1 + n_ring]

    def sp1():
        return A.denoise_step_paged(cfg, params, x[:1], t[:1], t[:1],
                                    home.pool.k, home.pool.v, tables, None,
                                    None, q_off[:1], is_dn[:1])

    if not lanes.sp_expand(0, 1):
        raise AssertionError("solo SP expand was not applied")
    tables_d = donor.pool.tables_for([0])[:, :1 + n_ring]

    def sp2():
        return A.denoise_step_paged_sp(
            cfg, params, x[:1], t[:1], t[:1], home.pool.k, home.pool.v,
            donor.pool.k, donor.pool.v, tables, tables_d, None, None,
            q_off[:1], is_dn[:1])

    reset()
    x1, kv1 = sp1()
    sync()
    got1 = launches()
    reset()
    x2, kv2 = sp2()
    sync()
    got2 = launches()
    print(f"  SP1 step launches {got1}\n  SP2 step launches {got2}")
    if got1["paged_chunk_attention"] != L or \
            got1["paged_chunk_attention (head-range views)"] != 0 or \
            got2["paged_chunk_attention"] != 2 * L or \
            got2["paged_chunk_attention (head-range views)"] != 2 * L:
        raise AssertionError("SP1 / SP2 steps: unexpected kernel launches")
    all_tc(got1, "SP1 step")
    all_tc(got2, "SP2 step")
    worst = max(same_or_ulp("SP2 vs SP1 step x_new", x2, x1),
                same_or_ulp("SP2 vs SP1 step chunk K", kv2["k"], kv1["k"]),
                same_or_ulp("SP2 vs SP1 step chunk V", kv2["v"], kv1["v"]))
    sp1_ms, sp2_ms = cuda_ms(sp1, 3), cuda_ms(sp2, 3)
    print(f"  step time at context {n_ring} chunks (1 row): SP1 "
          f"{sp1_ms:.2f} ms, SP2 {sp2_ms:.2f} ms (two half-head launches "
          f"per layer on one card)")

    # batch-axis SP: full-head pages mirrored into the donor pool, the
    # stream a guest row beside the donor's own stream 1
    lanes.sp_release(0)
    lanes.sp_mode = "batch"
    if not lanes.sp_expand(0, 1) or lanes.sp_link(0).mode != "batch":
        raise AssertionError("batch-axis SP expand was not applied")
    gtab = donor.pool.tables_for([0, 1])[:, :1 + n_ring]
    xb, kvb = A.denoise_step_paged(cfg, params, x, t, t, donor.pool.k,
                                   donor.pool.v, gtab, None, None, q_off,
                                   is_dn)
    sync()
    worst = max(worst,
                same_or_ulp("batch-axis guest row (2 rows) vs SP1 x_new",
                            xb[:1], x1),
                same_or_ulp("batch-axis guest row vs SP1 chunk K",
                            kvb["k"][:, :1], kv1["k"]))
    lanes.sp_release(0)
    lanes.sp_mode = "solo"

    # one migration through the host-spill path: pages bit-exact
    ctx = home.pool.gather([0], n_ring)
    ctx = (ctx[0].clone(), ctx[1].clone())
    in_before = donor.pool.transfer_bytes_in
    sync()
    t0 = time.perf_counter()
    if not lanes.migrate(0, 0, 1):
        raise AssertionError("migration was not applied")
    sync()
    mig_s = time.perf_counter() - t0
    moved = donor.pool.gather([0], n_ring)
    if not (torch.equal(moved[0], ctx[0]) and torch.equal(moved[1], ctx[1])):
        raise AssertionError("migrated pages differ")
    print(f"  migrate: pages bit-exact after the move, "
          f"{(donor.pool.transfer_bytes_in - in_before) / 1e9:.2f} GB in "
          f"{mig_s:.3f} s (host spill, then restore into the destination "
          f"pool)")
    print(f"  applied: migrations {lanes.n_migrations}, SP expands "
          f"{lanes.n_sp_expands}, SP releases {lanes.n_sp_releases}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del lanes, home, donor, ctx, moved, x1, kv1, x2, kv2, xb, kvb

    # ---- (ii) sessions: 2 lanes vs 1 lane ----------------------------------
    def serve(n_lanes, force):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pool = LanePool(n_lanes, cfg=cfg, params=params, max_streams=3,
                        device=DEV)
        sess = StreamingSession(
            SessionConfig(model_cfg=cfg, max_batch=1, device=DEV,
                          verbose=False),
            executor=pool, fidelity_policy=StaticFidelity(fid))
        for spec in uniform_specs(2, 3):
            sess.submit(spec)
        if force:
            state = {"mig": False, "sp": False, "rel": False}
            orig_tick = sess.control.tick

            def tick(view, now):
                d = orig_tick(view, now)
                s0, s1 = view.streams.get(0), view.streams.get(1)
                if (not state["mig"] and s0 is not None
                        and s0.chunks_done >= 1 and not s0.done
                        and not pool.is_inflight(0)):
                    src = pool.lane_of[0]
                    d.migrations.append(Migration(0, src, 1 - src,
                                                  cross_node=False))
                    state["mig"] = True
                if (not state["sp"] and s1 is not None
                        and s1.chunks_done >= 1 and not s1.done
                        and pool.ex(pool.lane_of[1]).pool.resident(1)):
                    d.sp_decisions.append(
                        SPDecision(1, 1 - pool.lane_of[1], "expand"))
                    state["sp"] = True
                elif (state["sp"] and not state["rel"] and s1 is not None
                        and not s1.done and s1.sp_donor is not None
                        and s1.chunks_done >= 2):
                    d.sp_decisions.append(SPDecision(1, s1.sp_donor,
                                                     "release"))
                    state["rel"] = True
                return d

            sess.control.tick = tick
        reset()
        t0 = time.perf_counter()
        res = sess.run()
        sync()
        wall = time.perf_counter() - t0
        got = launches()
        out = {sid: [c.clone() for c in sess.handles[sid].chunks]
               for sid in (0, 1)}
        print(f"  {n_lanes}-lane session: wall {wall:.2f} s (warm-up "
              f"included), applied migrations {res.n_migrations_applied}, "
              f"SP expands {res.n_sp_expands_applied}, releases "
              f"{res.n_sp_releases_applied}; launches {got}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if got["paged_chunk_attention"] == 0 or any(
                got[k] for k in counters if k != "paged_chunk_attention"):
            raise AssertionError(f"{n_lanes}-lane session launches {got}")
        all_tc(got, f"{n_lanes}-lane session")
        for sid, cs in out.items():
            if len(cs) != 3 or not all(bool(torch.isfinite(c).all())
                                       for c in cs):
                raise AssertionError(f"stream {sid}: bad chunks")
        return res, out

    _, ref = serve(1, False)
    res, two = serve(2, True)
    if (res.n_migrations_applied < 1 or res.n_sp_expands_applied < 1
            or res.n_sp_releases_applied < 1):
        raise AssertionError("the 2-lane session did not apply a migration "
                             "and an SP expand and release")
    for sid in (0, 1):
        for c in range(3):
            worst = max(worst, same_or_ulp(
                f"2-lane vs 1-lane session, stream {sid} chunk {c}",
                two[sid][c], ref[sid][c]))
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def phase_decode(record, counters):
    """Phase 11: the paged decode kernel against its plain version; the
    entry point's launches at decode_32k; timings and the bound."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.models.kvcache import to_fp8_e4m3

    gen = torch.Generator(device=DEV).manual_seed(97531)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = []
    fn = ops.paged_decode_attention

    def run(q, kp, vp, bt, lengths):
        """The entry point, its launch checked to have taken the kernel
        that ``decode_kernel_path`` names; returns (output, path)."""
        want = ops.decode_kernel_path(q.dtype, kp.dtype, q.shape[-1],
                                      q.shape[1] // kp.shape[2], kp.shape[1])
        before = (fn.launches, fn.launches_tc)
        out = fn(q, kp, vp, bt, lengths)
        sync()
        path = "mma" if fn.launches_tc > before[1] else "cuda_cores"
        if fn.launches != before[0] + 1 or path != want:
            raise AssertionError(f"decode launched on {path}, expected "
                                 f"{want}")
        return out, path

    def compare(name, got, want):
        if isinstance(got, tuple):
            got, path = got
            name = f"{name} ({path})"
        err = float((got.float() - want.float()).abs().max())
        limit = (TOL_DECODE_F32 if want.dtype == f32 else DECODE_BF16_ULPS
                 * ulp_bf16(float(want.float().abs().max())))
        print(f"  {name}: |d| {err:.3g} (limit {limit:.3g})")
        if not err <= limit or got.shape != want.shape \
                or got.dtype != want.dtype:
            raise AssertionError(f"{name}: decode kernel disagrees ({err})")
        errs.append(err)

    # the reference tests' shapes, fp32, and length 1
    for B, Hq, Hkv, D, page, npg, ptot, ln in (
            (2, 4, 2, 16, 8, 4, 16, None), (3, 8, 8, 32, 16, 3, 12, None),
            (1, 4, 1, 64, 8, 6, 8, None), (2, 4, 2, 16, 8, 2, 4, 1)):
        q = torch.randn((B, Hq, D), generator=gen, device=DEV)
        kp = torch.randn((ptot, page, Hkv, D), generator=gen, device=DEV)
        vp = torch.randn((ptot, page, Hkv, D), generator=gen, device=DEV)
        bt = torch.randint(0, ptot, (B, npg), generator=gen, device=DEV,
                           dtype=torch.int32)
        lengths = (torch.full((B,), ln, dtype=torch.int32, device=DEV)
                   if ln else torch.randint(1, npg * page + 1, (B,),
                                            generator=gen, device=DEV,
                                            dtype=torch.int32))
        compare(f"reference shape B={B} Hq={Hq} Hkv={Hkv} D={D} fp32",
                run(q, kp, vp, bt, lengths),
                ref.paged_decode_attention_ref(q, kp, vp, bt, lengths))
    # q and pages of different dtypes, e4m3 pages among them (the
    # reference widens all three to fp32 and returns q's dtype)
    for q_dtype, kv_name in ((bf16, "e4m3"), (f32, "e4m3"), (bf16, "fp32"),
                             (f32, "bf16")):
        cast = to_fp8_e4m3 if kv_name == "e4m3" else (
            lambda t, n=kv_name: t.to(f32 if n == "fp32" else bf16))
        B, Hq, Hkv, D, page, npg, ptot = 3, 12, 2, 128, 16, 8, 40
        q = torch.randn((B, Hq, D), generator=gen, device=DEV).to(q_dtype)
        kp = cast(torch.randn((ptot, page, Hkv, D), generator=gen,
                              device=DEV))
        vp = cast(torch.randn((ptot, page, Hkv, D), generator=gen,
                              device=DEV))
        bt = torch.randint(0, ptot, (B, npg), generator=gen, device=DEV,
                           dtype=torch.int32)
        lengths = torch.randint(1, npg * page + 1, (B,), generator=gen,
                                device=DEV, dtype=torch.int32)
        compare(f"q {str(q_dtype)[6:]} over {kv_name} pages, B={B} Hq={Hq} "
                f"Hkv={Hkv} D={D}",
                run(q, kp, vp, bt, lengths),
                ref.paged_decode_attention_ref(q, kp, vp, bt, lengths))

    # the edges of the split over the sequence (bf16 q): a stream one
    # token past a unit boundary, one stream of 32,768 tokens (128 units
    # of 256), lengths 0 and 1 in one batch (length 0 gives 0 from the
    # kernel, NaN from the plain version: live rows compared), D 64 and
    # pages of 8 and 64 tokens
    def edge(name, B, Hq, Hkv, D, page, npg, ptot, lengths, kv=bf16):
        cast = to_fp8_e4m3 if kv == torch.float8_e4m3fn else (
            lambda t: t.to(kv))
        q = torch.randn((B, Hq, D), generator=gen, device=DEV).to(bf16)
        kp = cast(torch.randn((ptot, page, Hkv, D), generator=gen,
                              device=DEV))
        vp = cast(torch.randn((ptot, page, Hkv, D), generator=gen,
                              device=DEV))
        bt = torch.randint(0, ptot, (B, npg), generator=gen, device=DEV,
                           dtype=torch.int32)
        ln = torch.tensor(lengths, dtype=torch.int32, device=DEV)
        got, path = run(q, kp, vp, bt, ln)
        want = ref.paged_decode_attention_ref(q, kp, vp, bt, ln)
        live = ln > 0
        if not bool((got[~live] == 0).all()):
            raise AssertionError(f"{name}: a length-0 row is not 0")
        compare(name, (got[live], path), want[live])

    unit = ops.decode_unit_tokens(2, 8, 256 * 16)
    edge(f"one token past a unit boundary (unit {unit}): lengths "
         f"{unit + 1}, {2 * unit + 1}", 2, 32, 8, 128, 16, 256, 600,
         [unit + 1, 2 * unit + 1])
    edge(f"B=1, 32768 tokens ({32768 // ops.decode_unit_tokens(1, 8, 32768)}"
         f" units)", 1, 32, 8, 128, 16, 2048, 4096, [32768])
    edge("lengths 0, 1, 0, 37 in one batch", 4, 8, 2, 128, 16, 4, 20,
         [0, 1, 0, 37])
    edge("D 64, pages of 8, G 8", 3, 16, 2, 64, 8, 40, 130, [320, 9, 161])
    edge("D 64 over e4m3 pages of 64, G 1", 3, 8, 8, 64, 64, 6, 20,
         [384, 65, 3], kv=torch.float8_e4m3fn)

    cfg = get_config(DECODE_ARCH)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S, page, P = (DECODE_SHAPE[k] for k in ("B", "S", "page", "pool"))
    n = S // page
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kp = torch.randn((P, page, Hkv, D), generator=gen, device=DEV, dtype=bf16)
    vp = torch.randn((P, page, Hkv, D), generator=gen, device=DEV, dtype=bf16)
    table = torch.randperm(P, generator=gen, device=DEV)[:B * n] \
        .view(B, n).to(torch.int32)
    q = torch.randn((B, Hq, D), generator=gen, device=DEV, dtype=bf16)
    full = torch.full((B,), S, dtype=torch.int32, device=DEV)
    drawn = torch.randint(1, S + 1, (B,),
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32).to(DEV)
    print(f"  {DECODE_ARCH}: Hq {Hq}, Hkv {Hkv}, D {D}, B {B}, context {S}, "
          f"pages of {page} from a pool of {P} ({kp.numel() * 2 / 1e9:.2f} "
          f"GB each for K and V)")

    # the main path: the entry point at decode_32k, counts read after
    reset_counts(counters)
    out = {"all lengths 32768": ops.paged_decode_attention(q, kp, vp, table,
                                                           full),
           "lengths drawn from [1, 32768]": ops.paged_decode_attention(
               q, kp, vp, table, drawn)}
    sync()
    launches = {k: c.launches for k, c in counters.items()}
    if launches != {**{k: 0 for k in counters}, "paged_decode_attention": 2} \
            or fn.launches_tc != 2:
        raise AssertionError(f"decode launches {launches}, "
                             f"{fn.launches_tc} on the tensor cores")
    print(f"  entry point at decode_32k: {fn.launches} launches, "
          f"{fn.launches_tc} on the tensor cores (split into units of "
          f"{ops.decode_unit_tokens(B, Hkv, S)} tokens)")
    record["launches"] = launches["paged_decode_attention"]

    def plain(lengths):
        r = DECODE_PLAIN_ROWS
        return torch.cat([ref.paged_decode_attention_ref(
            q[i:i + r], kp, vp, table[i:i + r], lengths[i:i + r])
            for i in range(0, B, r)])

    for (name, got), lengths in zip(out.items(), (full, drawn)):
        compare(f"decode_32k bf16, {name} (mma)", got, plain(lengths))
    kernel_ms = cuda_ms(lambda: ops.paged_decode_attention(
        q, kp, vp, table, full), 10)
    drawn_ms = cuda_ms(lambda: ops.paged_decode_attention(
        q, kp, vp, table, drawn), 10)
    plain_ms = cuda_ms(lambda: plain(full), 2)

    def bound(lengths):
        """Visible K/V (and the table entries naming their pages, q, the
        lengths, the output) over the memory rate; 4 x D operations per
        query head and visible token over the bf16 peak."""
        vis = int(lengths.sum())
        pages = int(((lengths + page - 1) // page).sum())
        nbytes = (2 * vis * Hkv * D * 2 + pages * 4 + B * 4
                  + 2 * B * Hq * D * 2)
        flops = 4.0 * vis * Hq * D
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["torch.bfloat16"] * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations"), nbytes

    bound_ms, bound_by, nbytes = bound(full)
    drawn_bound, _, drawn_bytes = bound(drawn)
    print(f"  all lengths 32768: kernel {kernel_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
          f"{nbytes / 1e9:.2f} GB), achieved "
          f"{nbytes / kernel_ms / 1e6:.0f} GB/s")
    print(f"  lengths drawn from [1, {S}] (seed 0): kernel {drawn_ms:.3f} "
          f"ms, bound {drawn_bound:.3f} ms ({drawn_bytes / 1e9:.2f} GB), "
          f"achieved {drawn_bytes / drawn_ms / 1e6:.0f} GB/s")

    # the library yardstick: SDPA over the context gathered beforehand
    # (the gather is not timed), one query row per head
    def gathered(pool):
        g = ref.gather_pages(pool, table)              # [B, S, Hkv, D]
        out = g.transpose(1, 2).contiguous()
        del g
        return out

    kt = gathered(kp)
    vt = gathered(vp)
    qt = q.view(B, Hq, 1, D)

    def library():
        # the flash backend only: the math backend would repeat the KV
        # heads (68 GB at decode_32k)
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True)

    library_ms = cuda_ms(library, 5)
    lib_err = float((library().view(B, Hq, D).float()
                     - out["all lengths 32768"].float()).abs().max())
    lib_limit = 8 * ulp_bf16(float(out["all lengths 32768"].float()
                                   .abs().max()))
    print(f"  SDPA (flash backend, enable_gqa, context gathered beforehand): "
          f"{library_ms:.3f} ms, vs the kernel |d| {lib_err:.3g} (limit "
          f"{lib_limit:.3g}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not lib_err <= lib_limit:
        raise AssertionError(f"decode kernel disagrees with SDPA ({lib_err})")
    del kt, vt
    gc.collect()
    torch.cuda.empty_cache()

    # e4m3 pages (knob Q's pools) at decode_32k, bf16 q, all lengths full
    kp, vp = to_fp8_e4m3(kp), to_fp8_e4m3(vp)
    compare("decode_32k bf16 q over e4m3 pages, all lengths 32768",
            run(q, kp, vp, table, full), plain(full))
    fp8_ms = cuda_ms(lambda: ops.paged_decode_attention(
        q, kp, vp, table, full), 10)
    fp8_bytes = nbytes - 2 * B * S * Hkv * D   # one byte a K/V element
    print(f"  e4m3 pages, all lengths 32768: kernel {fp8_ms:.3f} ms, bound "
          f"{fp8_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes; "
          f"{fp8_bytes / 1e9:.2f} GB), achieved "
          f"{fp8_bytes / fp8_ms / 1e6:.0f} GB/s")
    del kp, vp, q, out
    gc.collect()
    torch.cuda.empty_cache()
    record.update(max_abs_err=max(errs), ms=kernel_ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=library_ms)


def phase_fp8(record, counters):
    """Phase 12: the scaled fp8 matmul kernels against their plain
    version, each shape on the path ``kernel_path`` names, at the
    reference's criterion at its test shapes and within TOL_FP8_REL of
    max |out| elsewhere, all-positive operands among them;
    the entry point's launches at the two FFN shapes, both on the tensor
    cores; timings, the bound and ``torch._scaled_mm``."""
    from repro_torch.kernels.fp8_matmul import ops, ref

    gen = torch.Generator(device=DEV).manual_seed(8642)
    bf16 = torch.bfloat16
    errs, tc_gaps = [], []

    def compare(name, got, want, path, elementwise=False):
        top = float(want.abs().max())
        d = (got.float() - want.float()).abs()
        err = float(d.max())
        if elementwise:       # the reference's rtol = atol = TOL_FP8_REL
            worst = float((d / (TOL_FP8_REL
                                + TOL_FP8_REL * want.float().abs())).max())
            print(f"  {name} ({path}): |d| {err:.3g} = {err / top:.3g} of "
                  f"max |out| {top:.3g}; worst |d| / (1e-5 + 1e-5 |want|) "
                  f"{worst:.3g} (limit 1)")
            ok = worst <= 1.0
        else:
            print(f"  {name} ({path}): |d| {err:.3g} = {err / top:.3g} of "
                  f"max |out| {top:.3g} (limit {TOL_FP8_REL:g} of it)")
            ok = err <= TOL_FP8_REL * max(top, 1e-30)
        if not ok or got.shape != want.shape:
            raise AssertionError(f"{name}: fp8 kernel disagrees ({err})")
        errs.append(err)
        if path == "wgmma":
            tc_gaps.append(err / top)

    def launch(xq, wq, sx, sw, **kw):
        """One kernel call; checks that it took kernel_path's kernel."""
        path = ops.kernel_path(xq.shape[1], wq.shape[1])
        before = ops.fp8_scaled_matmul.launches_tc
        out = ops.fp8_scaled_matmul(xq, wq, sx, sw, **kw)
        if ops.fp8_scaled_matmul.launches_tc - before != int(
                path == "wgmma"):
            raise AssertionError(f"fp8 launch off its path {path}")
        return out, path

    # the reference tests' shapes, and two whose K or N is not a multiple
    # of 16 (the CUDA-core kernel)
    for M, K, N in ((64, 64, 64), (128, 256, 64), (32, 32, 32),
                    (200, 136, 264), (1, 4096, 300)):
        x = torch.randn((M, K), generator=gen, device=DEV)
        w = torch.randn((K, N), generator=gen, device=DEV)
        xq, sx = ops.quantize_fp8(x, 1)
        wq, sw = ops.quantize_fp8(w, 0)
        out, path = launch(xq, wq, sx, sw)
        compare(f"reference shape M={M} K={K} N={N}", out,
                ref.fp8_matmul_ref(xq, wq, sx, sw), path,
                elementwise=(M, K, N) in FP8_REF_SHAPES)

    # |randn| operands at K = 4096: every truncation of the tensor cores'
    # fp32 accumulator errs the same way, the worst case for a long sum
    x = torch.randn((512, 4096), generator=gen, device=DEV).abs()
    w = torch.randn((4096, 512), generator=gen, device=DEV).abs()
    xq, sx = ops.quantize_fp8(x, 1)
    wq, sw = ops.quantize_fp8(w, 0)
    out, path = launch(xq, wq, sx, sw)
    compare("all-positive M=512 K=4096 N=512", out,
            ref.fp8_matmul_ref(xq, wq, sx, sw), path)

    gc.collect()
    torch.cuda.empty_cache()
    inputs = {name: (torch.randn((M, K), generator=gen, device=DEV,
                                 dtype=bf16),
                     torch.randn((K, N), generator=gen, device=DEV,
                                 dtype=bf16) * 0.02)
              for name, (M, K, N) in FP8_SHAPES.items()}
    # the main path: the online-quantized entry point, counts read after
    reset_counts(counters)
    outs = {name: ops.fp8_matmul(x, w) for name, (x, w) in inputs.items()}
    sync()
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches != {**{k: 0 for k in counters}, "fp8_matmul": 2} \
            or ops.fp8_scaled_matmul.launches_tc != 2:
        raise AssertionError(f"fp8 launches {launches}, on the tensor "
                             f"cores {ops.fp8_scaled_matmul.launches_tc}")
    print("  both FFN shapes through the entry point on the tensor cores")
    record["launches"] = launches["fp8_matmul"]

    first = True
    for name, (M, K, N) in FP8_SHAPES.items():
        x, w = inputs[name]
        xq, sx = ops.quantize_fp8(x, 1)
        wq, sw = ops.quantize_fp8(w, 0)
        compare(f"{name} (M {M}, K {K}, N {N})", outs.pop(name),
                ref.fp8_matmul_ref(xq, wq, sx, sw), ops.kernel_path(K, N))
        if not first:
            # quantize_fp8 on the card equals the CPU's bit for bit
            for t, axis in ((x, 1), (w, 0)):
                qg, sg = ops.quantize_fp8(t, axis)
                qc, sc = ops.quantize_fp8(t.cpu(), axis)
                bad_q = int((qg.cpu().view(torch.uint8)
                             != qc.view(torch.uint8)).sum())
                bad_s = int((sg.cpu() != sc).sum())
                if bad_q or bad_s:
                    raise AssertionError(f"quantize_fp8 card != CPU: {bad_q}"
                                         f" fp8 bytes, {bad_s} scales")
            print("  quantize_fp8 on the card == on the CPU, bit for bit "
                  f"(x and w of {name})")
        kernel_ms = cuda_ms(lambda: ops.fp8_scaled_matmul(xq, wq, sx, sw),
                            3 if first else 10)
        plain_ms = cuda_ms(lambda: ref.fp8_matmul_ref(xq, wq, sx, sw), 2)
        flops = 2.0 * M * N * K
        nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
        t_ops = flops / PEAK_FLOPS["torch.float8_e4m3fn"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        # the library yardstick: cuBLASLt's fp8 GEMM with row-wise scales
        # (it does not sum in fp32 either); its column-major w_col is made
        # here, outside its timing (the kernel reads w_q as it is)
        w_col = wq.t().contiguous().t()
        library_ms, lib_dtype = None, None
        for out_dtype in (bf16, torch.float32):
            try:
                lib = torch._scaled_mm(xq, w_col, scale_a=sx, scale_b=sw,
                                       out_dtype=out_dtype)
            except (RuntimeError, TypeError) as e:
                print(f"  torch._scaled_mm, out {out_dtype}: refused "
                      f"({str(e).splitlines()[0][:120]})")
                continue
            library_ms = cuda_ms(lambda: torch._scaled_mm(
                xq, w_col, scale_a=sx, scale_b=sw, out_dtype=out_dtype),
                10 if not first else 5)
            lib_dtype = out_dtype
            want = ref.fp8_matmul_ref(xq, wq, sx, sw)
            rel = float((lib.float() - want).abs().max()
                        / want.abs().max())
            print(f"  torch._scaled_mm (row-wise scales, out "
                  f"{out_dtype}): {library_ms:.3f} ms; vs the plain "
                  f"version max |d| / max |out| {rel:.3g}")
            del lib, want
            break
        # the exact sum runs on the bf16 tensor cores: its own floor
        bf16_ms = flops / PEAK_FLOPS[str(bf16)] * 1e3
        print(f"  {name}: kernel {kernel_ms:.3f} ms (fp32 out), plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by} at "
              f"the fp8 rate; {flops / 1e12:.3f} TFLOP, "
              f"{nbytes / 1e9:.3f} GB), {bf16_ms:.3f} ms at the bf16 rate "
              f"of the exact sum, achieved "
              f"{flops / kernel_ms / 1e9:.2f} TFLOP/s")
        if first:
            record.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms,
                          library_out_dtype=str(lib_dtype))
        first = False
        del xq, wq, sx, sw, w_col
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  gap on the tensor cores: worst {max(tc_gaps):.3g} of max "
          f"|out| over {len(tc_gaps)} shapes (limit {TOL_FP8_REL:g})")
    record["max_abs_err"] = max(errs)


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
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.fp8_matmul import ops as fp8_ops
        from repro_torch.kernels.paged_attention import ops as paged_ops
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    print("== phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    sources = [paged_ops.SOURCE, paged_ops.DECODE_SOURCE, flash_ops.SOURCE,
               ssd_ops.SOURCE, fp8_ops.SOURCE]
    t0 = time.perf_counter()
    build.build(sources)
    print(f"  built {', '.join(s.name for s in sources)} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for src in sources:
        entries, serialized = ptxas_entries(
            build.BUILD_LOGS.get(str(src), ""))
        for tc in (False, True):
            part = [e for e in entries
                    if ("wgmma" in e[0] or "_mma_kernel" in e[0]) == tc]
            if not part:
                continue
            regs = [e[1] for e in part]
            print(f"  ptxas {src.name}{' (tensor cores)' if tc else ''}: "
                  f"{len(part)} instantiations, {min(regs)}-{max(regs)} "
                  f"registers per thread, {sum(e[2] for e in part)} bytes "
                  f"of spills")
            for name, _, spill in part:
                if spill:
                    print(f"    {spill} bytes of spills in {name}")
        if serialized:
            print(f"  ptxas {src.name}: {serialized} wgmma serialization "
                  f"notes (C75xx)")

    paged = {"name": "paged_chunk_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/paged_attention/csrc/"
                       "paged_chunk_attention.cu",
             "replaces": "src/repro/kernels/paged_attention/kernel.py:197"}
    flash = {"name": "flash_mha", "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_mha.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:132",
             "path": "wgmma"}
    ssd = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:81",
           "path": "wgmma"}
    decode = {"name": "paged_decode_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/paged_attention/csrc/"
                        "paged_decode_attention.cu",
              "replaces": "src/repro/kernels/paged_attention/kernel.py:84",
              "path": "mma"}
    fp8 = {"name": "fp8_matmul", "route": "cuda",
           "source": "src/repro_torch/kernels/fp8_matmul/csrc/fp8_matmul.cu",
           "replaces": "src/repro/kernels/fp8_matmul/kernel.py:42",
           "path": "wgmma"}
    counters = {"paged_chunk_attention": paged_ops.paged_chunk_attention,
                "flash_mha": flash_ops.flash_mha,
                "paged_decode_attention": paged_ops.paged_decode_attention,
                "fp8_matmul": fp8_ops.fp8_scaled_matmul}
    print("== phase 2: paged kernel vs plain version at full-width shapes")
    phase_kernel(paged)
    print("== phase 3: flash kernel vs plain version")
    phase_flash(flash)
    print("== phase 4: reduced config, card vs CPU")
    phase_integration()
    cfg, params = full_width_params()
    print("== phase 5: full-width ardit-self-forcing, batched paged session")
    paged["launches"] = phase_batched(cfg, params, counters)
    print("== phase 6: full-width ardit-self-forcing, sequential session")
    flash["launches"] = phase_sequential(cfg, params, counters)
    print("== phase 7: full-width ardit-self-forcing, gather-backend session")
    phase_gather(cfg, params, counters)
    print("== phase 10: full-width elastic SP and migration, two lanes")
    phase_lanes(cfg, params, counters)
    del cfg, params
    print("== phase 8: SSD kernel vs plain version")
    phase_ssd(ssd)
    print(f"== phase 9: full-width {SSM_ARCH} prefill and decode")
    ssd["launches"] = phase_ssm({**counters, "ssd": ssd_ops.ssd})
    print(f"== phase 11: paged decode kernel vs plain version ({DECODE_ARCH} "
          f"decode_32k)")
    phase_decode(decode, counters)
    print("== phase 12: fp8 matmul kernel vs plain version")
    phase_fp8(fp8, counters)

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s, build included")
    keys = ("name", "route", "source", "replaces", "path", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in (paged, decode, flash, ssd,
                                            fp8)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
