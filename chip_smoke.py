#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Card: name and power limit from nvidia-smi; build every CUDA kernel
   of the port from ``src/repro_torch/kernels/*/csrc`` with nvcc (seven
   sources, one nvcc per source, started together).
2. Paged kernel vs plain version on the card at the batched path's
   full-width shapes (ardit-self-forcing: Sq = 2640, Hq = Hkv = 12, D =
   128, page = 2640, 8-entry tables): all-visible and explicit mask
   with drops / a hole row / a row that sees nothing, over bf16 and
   e4m3 pages, with and without the extent hint, GQA 4 (all on the
   tensor-core kernel), fp32 (the CUDA-core kernel); each case's path
   checked.  Times the kernel over bf16 and e4m3 pages, the plain
   version and one PyTorch library call computing the same attention,
   with the card's bound and the achieved TFLOP/s; then the same
   all-visible cases, checks and timings at ardit-causal-forcing's
   heads (Hq = Hkv = 16, D = 96: two 64-column TMA boxes, the second
   half zero-filled), on the tensor cores.
3. Flash kernel vs plain version on the card at the sequential path's
   full-width shapes (B = 1, Sq = 2640, 12 heads of 128, bf16,
   non-causal, Skv = sink + 0 / 3 / 7 chunks + the chunk) and in every
   mode at modest shapes (causal with q_offset, sink + window, the rho
   keep matrix, GQA, fp32, head dims 16 and 96); each case's kernel path
   (bf16 at D 64 / 96 / 128 on the tensor cores, the rest on the CUDA
   cores) checked, the tensor-core kernel's registers printed, the same
   timings with the kernel's and SDPA's TFLOP/s; then the token
   families' prefill_32k attention at B = 2 (granite-moe-1b-a400m causal
   at 16 / 8 heads of 64, minitron-8b causal at 32 / 8 heads of 128,
   jamba-v0.1-52b's sink 128 + window 8,192 at 32 / 8 heads of 128): the
   kernel against one plain call, SDPA (causal with ``enable_gqa``; the
   window as a boolean mask on the memory-efficient backend) and the
   bound of the visible pairs; then whisper-medium's three non-causal
   shapes at B = 2, 16 heads of 64 (the encoder's 1,500 x 1,500, the
   prefill's cross-attention 32,768 x 1,500 and a decode step's 1 x
   1,500: partial tiles on both axes, one live query row), each on the
   tensor cores against its plain version, timed beside SDPA and the
   bound.
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
   at the reduced (P, N); the bf16 cases again at jamba-v0.1-52b's (P,
   N) = (64, 16) (the chained grid 2,496 blocks of 4 heads, the partial
   group 7 heads); each case's kernel path checked
   (bf16 at (64, 128) and (64, 16) on the tensor cores, the rest on the
   CUDA cores); the same timings (no library call computes the scan);
   then Jamba's Mamba sublayers at full width ((64, 16), 128 heads,
   x/B/C the model's views) on the tensor cores, held and timed the same
   way, a second call equal bit for bit, and the CUDA-core passes at the
   same shape held and timed beside it.
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
   launch on the tensor cores.  (iii) Lanes on different devices, a lane
   on the card beside a lane on the CPU (``LanePool(devices=[cuda,
   cpu])``): at full width a stream with 2 chunks of context migrates
   card -> CPU -> card (each a measured PCIe move, its bytes, seconds and
   GB/s printed, pages bit for bit, the engine's ``bw_intra`` calibrated
   from them); at the reduced config (fp32) batch-axis SP with the guest
   on the CPU lane against the card's SP1 run, and a 2-device session
   that migrates one stream and borrows another against a 1-lane session
   on the card, within 1e-4 (the card and the CPU round differently).
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

13. The step cache at full width (run right after phase 10, on phase
   5's weights; ``ardit-self-forcing``, bf16, batched paged): (i) a
   session with ``step_cache=True`` under a static cache-off fidelity
   builds no manager and gives chunks bit-identical to
   ``step_cache=False``; one stream on ``aggressive`` over phase 5's
   weights, every hit decision checked against its threshold and the
   deltas printed (their velocity moves past the threshold, so the
   cache does not fire); then, on the same weights with the adaLN gates
   opened at ``SMOOTH_GATES`` in place of 0.2: (ii) the executor driven
   directly, 2 streams x
   3 chunks, all off against stream 1 on ``aggressive``: hits > 0 and
   stream 0's chunks bit-identical (hit rows ride as no-ops); (iii) one
   stream x 3 chunks, aggressive against off: skipped launches > 0,
   fewer dispatches, paged launches = n_layers x dispatches, all on the
   tensor cores, every hit's output x - dt v (one rounding) bit for
   bit, the drift against off printed, and the first chunk's steps
   traced one by one (wall, device busy, idle share); (iv) a session
   with ``step_cache=True`` under the default BMPR policy, 3 streams x
   3 chunks, at playout budgets from ``FACTORS_IV`` until BMPR picks a
   cache level: the fidelity mix, the step-cache counters and the
   chunk latency EMAs.
14. Co-serving at full width: ``ardit-self-forcing`` (phase 5's
   weights) beside ``ardit-causal-forcing`` (16 heads of 96, random
   weights from a seed, gates opened), 2 streams of each x 2 chunks,
   ``pool_streams`` 2 per bundle, a static fidelity: no unserved
   stream, every sub-batch of one model, both ``Summary.by_model``
   rows, paged launches = n_layers x dispatches per model (counted by
   head dim), all on the tensor cores; each model's chunks against its
   solo session (bit-identical or within 1 bf16 ulp, phase 10's rule);
   a single-bundle session against the ``model_cfg`` path, bit for bit.
15. The simulator calibrated from the card: ``fit_session`` on phase 13
   (iv)'s session replayed through ``Simulator`` on the calibrated
   profile (ratios, scale, cache speedups and the agreement printed,
   not gated: the tolerance was pinned for the reduced CPU session),
   and the per-bundle fits of phase 14's session.

16. The token families at full width through the registry API (run
   after 12, everything before it freed; random weights from a CUDA
   generator): ``minitron-8b`` (dense), ``granite-moe-1b-a400m`` (MoE,
   heads of 64), ``internvl2-26b`` (VLM, 256 image embeddings
   prepended) and ``jamba-v0.1-52b`` cut to one period of 8 sublayers
   (hybrid), each with the launch counts set to 0 before and read
   after every prefill and decode run (flash = attention layers per
   prefill, on the tensor cores in bf16; ssd_scan = 7 per Jamba period,
   on the tensor cores; nothing from decode but whisper-medium's
   cross-attention): a timed prefill (B 2 x
   32,768; internvl 1 x 8,192) and decode steps (Jamba's past its
   8,320-token ring), then consistency gates (``FamilyRun.gate``): the
   last of 512 greedy decode steps against a teacher-forced prefill, in
   bf16 at the timed length (MoE capacity 8.0; Jamba 1 x 12,288, the
   ring rolled) and with the weights widened to fp32 at 2 x 4,096 on
   the first quarter of the layers (minitron 8 of 32, granite 6 of 24;
   full width, 512 steps, the same limit); peak memory per model.
   ``whisper-medium`` (encoder-decoder, 24 + 24 layers over 1,500 stub
   audio frames) the same way: prefill 2 x 32,768 + 32 decode steps,
   gates in bf16 at 2 x 32,768 and in fp32 at 2 x 4,096 on 6 + 6 of its
   layers; flash = 72 per prefill at full depth, 18 at 6 + 6 (encoder,
   causal self-attention, cross-attention) and one per decoder layer a
   decode step (the cross-attention; its self-attention is the plain
   decode attention).
17. The ring batched cache at full width (run after 15, on phase 5's
   weights): the batched paged executor serves 2 streams x 2 chunks at
   top fidelity and one fp8 chunk each; before each chunk the pool's
   pages are assembled into the ring layout and ``serve_chunk_batched``
   serves the same chunk from it with the same noise: its latents'
   relative L2 gap to the executor's (kernel 1 against the plain masked
   segment) within twice the gap that rounding the context's P to bf16
   (kernel 1's rounding) makes in the ring path itself, and at least
   within 2^-6; the ring outside the chunk's new slot unchanged; then
   the ring on its own from ``init_batched_cache`` (gaps printed: they
   compound through the context); the ring path launches no kernel.

18. The flash kernel's backward (run after 16 with everything before it
   freed) against its plain version on the same q, k, v, output,
   log-sum-exp and output gradient: at minicpm-2b's training attention
   (B 2, S 4,096, 36 heads of 64, causal) and ardit-self-forcing's (B 1,
   2,640 queries over 2,717 and 5,357 keys, 12 heads of 128) in bf16
   after the tensor-core forward, then GQA 4, sink + window, the rho keep
   matrix, q_offset, whisper-medium's 1,500 keys, D 96, rows that see
   nothing, fp32 at D 16 and 64.  bf16 at D 64 / 96 / 128 takes the
   tensor-core backward (``flash_mha_bwd_wgmma.cu``), held to the plain
   version that rounds P and dS to bf16 as it does, with each gradient's
   gap to the fp32 gradient of the plain forward within 2^-6 of its
   largest magnitude; fp32 and D 16 take the CUDA-core backward
   (``flash_mha_bwd.cu``), held to the unrounded plain version, which
   also holds it at the training shapes in bf16; each call's path
   checked by the launch counts; two calls bit for bit; the forward's lse
   against the plain version's; both backwards' times beside the bound,
   the plain version and SDPA's backward on its flash backend.
19. Training (after 18, on fresh parameters): (i) the reduced dense,
   MoE, VLM, encoder-decoder and AR-DiT configs, card against CPU (loss
   and every gradient leaf, kernel 3's forward and backward launches
   against the layers, every backward on the CUDA cores); mamba2-780m and
   jamba-v0.1-52b raise the SSD wrapper's autograd guard; (ii)
   ``launch/train.py``'s ``main`` at full width: minicpm-2b 3 steps at 2
   x 4,096 on one fixed batch (the loss must fall) and ardit-self-forcing
   2 steps at 1 x 2 chunks; s/step, tokens/s, peak memory, kernel 3's
   launches per step, every forward and every backward on the tensor
   cores; (iii) a checkpoint on the card: save, restore
   bit for bit (bf16 leaves included), continue.
20. Sharded steps on a 1x1 mesh (after 19): an NCCL group of world 1 on
   the card and the mesh (data 1, model 1), destroyed at the end of the
   phase.  (i) minicpm-2b trained as phase 19 (ii) trains it (2 x 4,096,
   remat, lr 1e-5, seed 0, one fixed batch), 2 steps unsharded and then
   2 steps with DTensor parameters and moments through
   ``loop.make_sharded_train_step``: the losses equal phase 19's and
   every parameter the unsharded steps' bit for bit, kernel 3's forward
   and tensor-core backward launched on the local tensors (counted);
   s/step printed beside phase 19's.  (ii) mamba2-780m served sharded: a
   prefill of 2 x 4,096 and 8 greedy decode steps through the registry
   API under the serving rules, params by ``param_shardings(serve=True)``
   and the state by ``lowering.cache_shardings``, bit for bit with the
   unsharded calls, kernel 4 launched on the local heads once per layer.
   (iii) phase 19 (iii)'s checkpoint setup restored with ``shardings=``
   onto the mesh equals the saved state bit for bit.  (iv)
   ``compressed_psum`` of a gradient of minicpm-2b's embedding shape over
   the world-1 group equals ``decompress(compress(g + err))`` bit for
   bit; its time printed.
21. The reference's examples as the port's entry points (after 20, at
   the reduced configs): ``repro_torch.examples.quickstart`` on the card
   (BMPR, the 100-stream simulator, two AR-DiT chunks: kernel 3's
   launches = layers x forwards, on the CUDA cores in fp32; the chunks
   against the same inputs on the CPU within TOL_CARD_CPU), then
   ``examples.train_small`` (40 steps of minicpm-2b with a checkpoint,
   a restart and an uninterrupted run: every leaf of the parameters and
   the optimizer state bit for bit, or it raises; kernel 3's forward and
   CUDA-core backward launches counted per train step), each one's
   seconds printed.

Every phase prints its seconds.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Without a CUDA device, or outside a checkout of the repository,
it exits non-zero and prints no result.
"""
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
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
# the H100's special-function units: 16 exponentials (ex2) a clock on
# each of its 132 SMs
EX2_PER_CLOCK_SM, SMS = 16, 132

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
# reduced-config steps and chunks, card vs CPU (fp32, TF32 off); also
# phase 10's lanes on the card beside lanes on the CPU (the executor
# tolerance of the reference's device-lane spec)
TOL_CARD_CPU = 1e-4
# phase 17: the ring batched path (``serve_chunk_batched``: the plain
# masked segment, fp32 softmax) against the batched paged executor
# (kernel 1 on the tensor cores, P rounded to bf16 before P V) on the
# same weights, noise and cache, as the relative L2 gap of one chunk's
# latents.  Phase 2 holds kernel 1 within 2 bf16 ulps of its plain
# version, a rounding of P to bf16; 30 layers x 5 passes then amplify
# such a rounding into a few percent of a chunk's latents (an NVIDIA
# H100 80GB HBM3 at 700 W gave 0.008, 0.025 and 0.021 from the same
# cache, where 2^-6 had been predicted).  So the limit is measured on
# the same chunk: the ring path's own response to that rounding (the
# plain segment with the context's P rounded to bf16 before P V, as
# kernel 1 rounds it), times RING_SENSITIVITY_FACTOR, and never below
# TOL_RING_REL.  A wrong slot, mask or offset moves a chunk by the order
# of the latents (another stream's chunk: ~1.0).
RING_SENSITIVITY_FACTOR = 2.0
TOL_RING_REL = 2.0 ** -6
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
# whisper-medium's random weights make its logits nearly independent of
# the position (another position's logits 0.014 from the compared ones
# in bf16, 0.029 in fp32, on the same card), so its bf16 gate cannot
# tell a wrongly carried state from rounding; its fp32 gate (1.3e-6
# there) does.
TOL_CONSISTENCY = 0.1
TOL_CONSISTENCY_F32 = 1e-4
# phase 16's bf16 gates of the MoE models: where the two paths route the
# compared token to different experts in some MoE sublayer (a near-tie
# between the k-th and the next expert, which bf16 rounding resolves one
# way on each path), the gap is that of another expert's output, not of
# a carried state: jamba-v0.1-52b's one period (top 2 of 16) on an
# NVIDIA H100 80GB HBM3 (700 W) gave 0.278-0.310 with a flip and
# 0.018-0.020 without, against 1.37-1.41 to another position's logits.
# Only then the limit is TOL_CONSISTENCY_FLIP, and at most half the gap
# to another position's logits (a wrongly carried state gives a gap of
# that order): granite-moe's is 0.197 there.
TOL_CONSISTENCY_FLIP = 0.5
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
# ardit-causal-forcing's attention at the same shape: 16 heads of 96
# (16 x 96 = 12 x 128 = 1,536 per token, so the same operations)
KERNEL_D96 = dict(H=16, D=96)
# the sequential path's attention at full width: one stream, the chunk's
# 2640 queries over sink + w chunks + the chunk itself
FLASH_SKV = (77 + 2640, 77 + 3 * 2640 + 2640, 77 + 7 * 2640 + 2640)
# the flash kernel at the token families' prefill_32k attention (batch
# cut to 2): name -> (B, S, Hq, Hkv, D, window, sink)
FLASH_PREFILL = {
    "granite-moe-1b-a400m causal, heads of 64":
        (2, 32768, 16, 8, 64, 0, 0),
    "minitron-8b causal, GQA 4, heads of 128":
        (2, 32768, 32, 8, 128, 0, 0),
    "jamba-v0.1-52b sink 128 + window 8192, heads of 128":
        (2, 32768, 32, 8, 128, 8192, 128),
}
# the flash kernel at whisper-medium's three new shapes (B 2, 16 heads of
# 64, bf16, non-causal): name -> (B, Sq, Skv); the encoder's 1,500 stub
# audio frames, the prefill's cross-attention over them at prefill_32k's
# length, and a decode step's one query row over them
FLASH_WHISPER = {
    "whisper-medium encoder self-attention": (2, 1500, 1500),
    "whisper-medium prefill cross-attention": (2, 32768, 1500),
    "whisper-medium decode-step cross-attention": (2, 1, 1500),
}
WHISPER_HEADS, WHISPER_D = 16, 64
# phase 18, the flash kernel's backward at the training shapes of phase
# 19: name -> (B, Sq, Skv, heads, D, causal); minicpm-2b's attention at
# --batch 2 --seq 4096, and ardit-self-forcing's chunk of 2,640 queries
# over the sink and itself (the first chunk) or the sink, the first
# chunk and itself (the second)
BWD_MAIN = "minicpm-2b training attention, causal, 36 heads of 64"
BWD_TRAIN_SHAPES = {
    BWD_MAIN: (2, 4096, 4096, 36, 64, True),
    "ardit-self-forcing training attention, Skv 2,717": (
        1, 2640, 77 + 2640, 12, 128, False),
    "ardit-self-forcing training attention, Skv 5,357": (
        1, 2640, 77 + 2 * 2640, 12, 128, False),
}
# backward kernel vs plain version on the same inputs (o and lse from the
# forward kernel): both sum in fp32, in other orders; fp32 gradients
# within TOL_BWD_F32 of each gradient's largest magnitude, bf16 ones
# within BWD_BF16_ULPS bf16 ulps at it (each rounds one fp32 sum; the
# tensor-core kernel is held to the plain version that rounds P and dS
# to bf16 where it does); the forward's lse within TOL_LSE of the plain
# version's (fp32 in both, exp2.approx and summation order on the card)
TOL_BWD_F32 = 1e-4
BWD_BF16_ULPS = 4
TOL_LSE = 2e-4
# the tensor-core backward's gradients against the fp32 gradient of the
# plain forward, relative to each gradient's largest magnitude: the
# forward's bf16 P and output and the backward's bf16 P and dS give
# 0.1-1%; a rounding at the wrong place (an operand or a sum in bf16)
# gives more
TOL_BWD_GAP = 2.0 ** -6
# phase 19 (i): the reduced configs, card against CPU: name -> family
TRAIN_PARITY_ARCHS = ("minitron-8b", "granite-moe-1b-a400m", "internvl2-26b",
                      "whisper-medium", "ardit-self-forcing")
TRAIN_GUARDED_ARCHS = ("mamba2-780m", "jamba-v0.1-52b")
# phase 19 (ii): launch/train.py's arguments at full width.  minicpm-2b
# at the launcher's default lr 3e-4 (and at 1e-4, 3e-5) does not fall
# over 3 steps from a random init on an NVIDIA H100 80GB HBM3 (700 W):
# Adam's first steps move every weight by about the lr along a
# near-rank-1 gradient, which at d 2,304 and 40 layers blows up the
# logits (12.10 -> 13.23 -> 17.89 at 3e-4); 1e-5 falls (12.10 -> 11.69
# -> 10.20), as does 3e-6
TRAIN_FULL = {
    "minicpm-2b": ["--arch", "minicpm-2b", "--full", "--batch", "2",
                   "--seq", "4096", "--steps", "3", "--fixed-batch",
                   "--lr", "1e-5"],
    "ardit-self-forcing": ["--arch", "ardit-self-forcing", "--full",
                           "--batch", "1", "--seq", "5280", "--steps", "2",
                           "--fixed-batch"],
}
# phase 20: the sharded steps' shapes: (ii)'s prefill and decode steps
SHARD_SERVE = (2, 4096)
SHARD_DECODE_STEPS = 8
# (iv): minicpm-2b's embedding gradient (vocab x d_model)
COMPRESS_SHAPE = (122753, 2304)
# card vs CPU gradients at the reduced configs (fp32, TF32 off): loss and
# every gradient leaf within TOL_TRAIN of the CPU's largest magnitude of
# that leaf (summation order only, as phase 4's 1e-4)
TOL_TRAIN = 1e-4
SESSION_ARCH = "ardit-self-forcing"
# phase 13 (iv): playout budgets (x the top-fidelity warm-up chunk) tried
# in turn until BMPR picks a step-cache level for some chunk
FACTORS_IV = (1.0, 0.5, 0.3, 0.2, 0.1, 0.05)
# phase 13 (ii)-(iv): the scale the adaLN gates are opened at (phase 5's:
# 0.2).  With random weights at full width, 0.2 moves the velocity by
# more than the aggressive threshold (100%) between denoise steps, so
# the cache never fires there; the phase prints the deltas of both
SMOOTH_GATES = 0.05
# phase 14 co-serves it beside the paper's other model column
CO_ARCH = "ardit-causal-forcing"
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
    hint = dict(sink=sink, chunk_tokens=tc)

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

    def timed(H, D, label):
        """(a) the main path's all-visible fast path, sink + 7 full ring
        pages, over bf16 and (e) e4m3 pages: each held to the plain
        version, then timed beside it, SDPA and the card's bound."""
        q, kp, vp, table = paged_case(gen, B, Sq, H, H, D, page, n, bf16,
                                      bf16)
        path = run(f"all-visible bf16{label}", q, kp, vp, table, None,
                   **hint)
        kf, vf = to_fp8_e4m3(kp), to_fp8_e4m3(vp)
        fp8_path = run(f"all-visible fp8 pages{label}", q, kf, vf, table,
                       None, **hint)
        reset_counts({"paged": fn})
        kernel_ms = cuda_ms(lambda: fn(q, kp, vp, table, None, **hint), 10)
        fp8_ms = cuda_ms(lambda: fn(q, kf, vf, table, None, **hint), 10)
        timed_n = (fn.launches, fn.launches_tc)
        plain_ms = cuda_ms(lambda: ref.paged_chunk_attention_ref(
            q, kp, vp, table, None, **hint), 3)
        fp8_plain_ms = cuda_ms(lambda: ref.paged_chunk_attention_ref(
            q, kf, vf, table, None, **hint), 3)

        # the library yardstick: SDPA over the gathered visible context
        # plus the chunk's own KV (the merged output, not the partials)
        ck = torch.randn((B, Sq, H, D), generator=gen, device=DEV).to(bf16)
        cv = torch.randn((B, Sq, H, D), generator=gen, device=DEV).to(bf16)
        bt = table.long()
        k_ctx = torch.cat([kp[bt[:, 0], :sink], kp[bt[:, 1:].reshape(-1),
                                                   :tc].view(B, -1, H, D)], 1)
        v_ctx = torch.cat([vp[bt[:, 0], :sink], vp[bt[:, 1:].reshape(-1),
                                                   :tc].view(B, -1, H, D)], 1)
        k_all = torch.cat([k_ctx, ck], 1).transpose(1, 2).contiguous()
        v_all = torch.cat([v_ctx, cv], 1).transpose(1, 2).contiguous()
        qt = q.transpose(1, 2).contiguous()

        def library():
            return F.scaled_dot_product_attention(qt, k_all, v_all)

        library_ms = cuda_ms(library, 5)
        merged = paged_mha(q, kp, vp, table, None, ck, cv, n_kv_heads=H,
                           **hint)
        lib_err = float((merged.float()
                         - library().transpose(1, 2).float()).abs().max())
        print(f"  paged_mha (kernel + in-chunk merge) vs SDPA{label}: |d| "
              f"{lib_err:.3g} (limit {TOL_SDPA:g})")
        if not lib_err <= TOL_SDPA:
            raise AssertionError(f"paged_mha disagrees with SDPA{label} "
                                 f"({lib_err})")

        # bound: each input read once, each output written once; 4 * rows
        # * D * visible tokens operations per (b, kv head), on the bf16
        # tensor cores whatever the page dtype (e4m3 pages are widened)
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
        print(f"  timed launches{label} {timed_n[0]}, on the tensor cores "
              f"{timed_n[1]} (path {path} for bf16 pages, {fp8_path} for "
              f"e4m3)")
        print(f"  all-visible B={B} ctx={ctx} H={H} D={D}, bf16 pages: "
              f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA "
              f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
              f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB), achieved "
              f"{flops / kernel_ms / 1e9:.2f} TFLOP/s")
        print(f"  all-visible B={B} ctx={ctx} H={H} D={D}, e4m3 pages: "
              f"kernel {fp8_ms:.3f} ms, plain {fp8_plain_ms:.3f} ms, bound "
              f"{fp8_bound:.3f} ms ({fp8_by}; {fp8_bytes / 1e6:.1f} MB), "
              f"achieved {flops / fp8_ms / 1e9:.2f} TFLOP/s")
        del k_ctx, v_ctx, k_all, v_all, qt, merged
        return (dict(path=path, ms=kernel_ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms), (q, kp, vp, kf, vf, table))

    # the main path's shape (ardit-self-forcing, D 128) fills the record
    main, (q, kp, vp, kf, vf, table) = timed(H, D, "")
    record.update(main)

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
    del q, kp, vp
    torch.cuda.empty_cache()

    # (f) ardit-causal-forcing's heads at the same shape: D 96 loads as
    # two 64-column TMA boxes, the second half zero-filled
    d96, _ = timed(KERNEL_D96["H"], KERNEL_D96["D"], " (D 96)")
    if d96["path"] != "wgmma":
        raise AssertionError(f"D 96 took the {d96['path']} path")
    record["d96"] = d96
    torch.cuda.empty_cache()

    # (d) fp32 queries and pages (the reduced configs' dtype), 3 entries
    q, kp, vp, table = paged_case(gen, B, Sq, H, H, D, page, 3,
                                  torch.float32, torch.float32)
    run("all-visible fp32", q, kp, vp, table, None, **hint)
    del q, kp, vp
    torch.cuda.empty_cache()

    record["max_abs_err"] = max(errs)


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
    # D 96 / 128: the template's instantiations; D 64: its own kernel
    tc_regs = {("64" if "wgmma64" in name else
                re.search(r"ILi(\d+)E", name).group(1)): regs
               for name, regs, _ in entries if "wgmma" in name}
    print(f"  tensor-core kernel registers per thread at launch, by head "
          f"dim: {tc_regs or 'not in this build log'} (setmaxnreg then "
          f"gives the consumer warpgroups 232 at D 96 / 128 and 160 at "
          f"D 64, the producer 40 and 32)")

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
    errs += flash_prefill_shapes(gen, launch)
    errs += flash_whisper_shapes(gen, launch)
    record["max_abs_err"] = max(errs)


def visible_pairs(S, window, sink):
    """(query, key) pairs a causal prefill of S tokens computes, with a
    sliding window and its sink (window 0: plain causal)."""
    i = np.arange(S, dtype=np.int64)
    if not window:
        return int((i + 1).sum())
    return int((np.minimum(i + 1, window)
                + np.clip(i - window + 1, 0, sink)).sum())


def sm_clock_mhz():
    """The card's maximum SM clock (``nvidia-smi --query-gpu=
    clocks.max.sm``), in MHz."""
    return float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip())


def ex2_floor_ms(n_ex2):
    """The least time ``n_ex2`` exponentials take on the special-function
    units: EX2_PER_CLOCK_SM a clock on each of the SMS SMs at the card's
    maximum SM clock.  At D 64 a softmax's exponentials (one per visible
    (query, key) pair) cost about as much as its products."""
    return n_ex2 / (EX2_PER_CLOCK_SM * SMS * sm_clock_mhz() * 1e6) * 1e3


def flash_prefill_shapes(gen, launch):
    """Phase 3, the token families' prefill attention at full width
    (``FLASH_PREFILL``): kernel vs plain version, each on the tensor
    cores; the kernel, one plain call and SDPA timed beside the bound
    (the visible pairs' operations)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops, ref

    errs = []
    for name, (B, S, Hq, Hkv, D, window, sink) in FLASH_PREFILL.items():
        q, k, v = (torch.randn((B, S, h, D), generator=gen,
                               device=DEV).to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        kw = dict(n_kv_heads=Hkv, causal=True, window=window, sink=sink,
                  block_q=512, block_kv=512)
        out, path = launch(q, k, v, **kw)
        if path != "wgmma":
            raise AssertionError(f"{name}: on {path}, not the tensor cores")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = ref.flash_mha_ref(q, k, v, **kw)
        stop.record()
        sync()
        plain_ms = start.elapsed_time(stop)
        errs.append(compare_flash(f"{name} B={B} S={S} ({path})", out,
                                  want))
        del want
        kernel_ms = cuda_ms(lambda: ops.flash_mha(q, k, v, **kw), 5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            # an explicit boolean mask, the KV heads repeated: the
            # memory-efficient backend takes both
            pos = torch.arange(S, device=DEV)
            mask = (pos[None, :] <= pos[:, None]) & (
                (pos[None, :] > pos[:, None] - window)
                | (pos[None, :] < sink))
            kt, vt = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (kt, vt))

            def library():
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        library_ms = cuda_ms(library, 3)
        lib_err = float((out.float() - library().transpose(1, 2).float())
                        .abs().max())
        lib_limit = 8 * ulp_bf16(float(out.float().abs().max()))
        pairs = visible_pairs(S, window, sink)
        flops = 4.0 * B * Hq * pairs * D
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
        t_ops = flops / PEAK_FLOPS[str(q.dtype)] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        floor = (f"; exponential floor {ex2_floor_ms(B * Hq * pairs):.3f} "
                 f"ms" if D == 64 else "")
        print(f"  {name}: kernel ({path}) {kernel_ms:.3f} ms, "
              f"{flops / kernel_ms / 1e9:.2f} TFLOP/s; plain (one call) "
              f"{plain_ms:.1f} ms; SDPA {library_ms:.3f} ms ("
              f"{'memory-efficient, boolean mask' if window else 'causal'}"
              f", |d| to the kernel {lib_err:.3g}, limit {lib_limit:.3g});"
              f" bound {bound_ms:.3f} ms ({bound_by}; {flops / 1e12:.2f} "
              f"TFLOP over {pairs} visible pairs per head){floor}")
        if not lib_err <= lib_limit:
            raise AssertionError(f"{name}: flash kernel disagrees with SDPA"
                                 f" ({lib_err})")
        del q, k, v, qt, kt, vt, out
        gc.collect()
        torch.cuda.empty_cache()
    return errs


def flash_whisper_shapes(gen, launch):
    """Phase 3, whisper-medium's attention at full width
    (``FLASH_WHISPER``): the non-causal calls whose lengths end in
    partial tiles on both axes (1,500) and whose query axis may be one
    row; kernel vs plain version on the tensor cores, the kernel, the
    plain version and SDPA on the same q/k/v timed beside the bound."""
    from repro_torch.kernels.flash_attention import ops, ref

    errs = []
    H, D = WHISPER_HEADS, WHISPER_D
    for name, (B, Sq, Skv) in FLASH_WHISPER.items():
        q = torch.randn((B, Sq, H, D), generator=gen, device=DEV) \
            .to(torch.bfloat16)
        k, v = (torch.randn((B, Skv, H, D), generator=gen, device=DEV)
                .to(torch.bfloat16) for _ in range(2))
        kw = dict(n_kv_heads=H, causal=False)
        out, path = launch(q, k, v, **kw)
        if path != "wgmma":
            raise AssertionError(f"{name}: on {path}, not the tensor cores")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = ref.flash_mha_ref(q, k, v, **kw)
        stop.record()
        sync()
        plain_ms = start.elapsed_time(stop)
        errs.append(compare_flash(f"{name} B={B} Sq={Sq} Skv={Skv} "
                                  f"({path})", out, want))
        del want
        gc.collect()
        torch.cuda.empty_cache()
        iters = 5 if Sq > 1500 else 50
        kernel_ms = cuda_ms(lambda: ops.flash_mha(q, k, v, **kw), iters)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt)

        library_ms = cuda_ms(library, iters)
        lib_err = float((out.float() - library().transpose(1, 2).float())
                        .abs().max())
        lib_limit = 8 * ulp_bf16(float(out.float().abs().max()))
        flops = 4.0 * B * H * Sq * Skv * D
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
        t_ops = flops / PEAK_FLOPS[str(q.dtype)] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"  {name}: kernel ({path}) {kernel_ms:.4f} ms, "
              f"{flops / kernel_ms / 1e9:.2f} TFLOP/s, "
              f"{nbytes / kernel_ms / 1e6:.1f} GB/s; plain (one call) "
              f"{plain_ms:.3f} ms; SDPA {library_ms:.4f} ms (|d| to the "
              f"kernel {lib_err:.3g}, limit {lib_limit:.3g}); bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB); exponential floor "
              f"{ex2_floor_ms(B * H * Sq * Skv):.4f} ms")
        if not lib_err <= lib_limit:
            raise AssertionError(f"{name}: flash kernel disagrees with SDPA"
                                 f" ({lib_err})")
        del q, k, v, qt, kt, vt, out
        gc.collect()
        torch.cuda.empty_cache()
    return errs


def bwd_grads_close(name, got, want, dtype):
    """dq, dk, dv of the backward kernel against the plain version's on
    the same inputs: fp32 within TOL_BWD_F32 of each gradient's largest
    magnitude, bf16 within BWD_BF16_ULPS bf16 ulps at it."""
    errs = []
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        top = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        limit = (TOL_BWD_F32 * max(top, 1e-30) if dtype == torch.float32
                 else BWD_BF16_ULPS * ulp_bf16(top))
        errs.append((label, err, limit))
        if not err <= limit or g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: backward kernel {label} disagrees "
                                 f"with the plain version ({err} > {limit})")
    print(f"  {name}: " + "  ".join(f"|{lab}| {e:.3g} (limit {lim:.3g})"
                                    for lab, e, lim in errs))
    return max(e for _, e, _ in errs)


def phase_flash_bwd(record, record_tc):
    """Phase 18: the flash kernel's backward against its plain version
    ``flash_mha_bwd_ref`` on the same q, k, v, output, log-sum-exp and
    output gradient, at the two training shapes of phase 19 and in every
    mode at modest shapes: bf16 at D 64 / 96 / 128 on the tensor cores
    (``csrc/flash_mha_bwd_wgmma.cu``) against the plain version that
    rounds P and dS to bf16, with the gap to the fp32 gradient of the
    plain forward gated; the rest on the CUDA cores
    (``csrc/flash_mha_bwd.cu``) against the unrounded one, which also
    holds the CUDA-core kernel at the training shapes; two calls give the
    same bits; the forward's lse against the plain version's; timings of
    both backwards (forward excluded) beside the bound, the plain version
    and SDPA's backward on its flash backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops, ref

    fm = ops.flash_mha
    gen = torch.Generator(device=DEV).manual_seed(2468)
    bf16, f32 = torch.bfloat16, torch.float32

    def backward(name, q, k, v, out, lse, dout, mode, path):
        """One backward kernel held to its plain version: two calls, each
        launch on ``path``, bit for bit; returns (grads, largest error)."""
        before = (fm.launches_bwd, fm.launches_bwd_tc)
        got = ops.flash_mha_bwd(q, k, v, out, lse, dout, path=path, **mode)
        again = ops.flash_mha_bwd(q, k, v, out, lse, dout, path=path, **mode)
        tc = path == "wgmma"
        if (fm.launches_bwd - before[0], fm.launches_bwd_tc - before[1]) \
                != (2, 2 * tc):
            raise AssertionError(f"{name}: backward launches off the "
                                 f"{path} path")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: two backward calls differ")
        del again
        want = ref.flash_mha_bwd_ref(q, k, v, out, lse, dout,
                                     round_bf16=tc, **mode)
        B, Sq, Hq, D = q.shape
        blocks = ops.bwd_blocks(B, Sq, k.shape[1], Hq, k.shape[2], path)
        err = bwd_grads_close(
            f"{name} [{path} backward against the "
            f"{'rounding ' if tc else ''}plain version; {blocks[0]} dK/dV "
            f"+ {blocks[1]} dQ blocks]", got, want, q.dtype)
        return got, err

    def case(name, B, Sq, Skv, Hq, Hkv, D, dtype, kw, timed=False):
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=DEV).to(dtype)
        k, v = (torch.randn((B, Skv, Hkv, D), generator=gen, device=DEV)
                .to(dtype) for _ in range(2))
        dout = torch.randn((B, Sq, Hq, D), generator=gen, device=DEV) \
            .to(dtype)
        mode = {**dict(n_kv_heads=Hkv, causal=True, q_offset=0, window=0,
                       sink=0, sparsity=0.0, block_q=128, block_kv=128),
                **kw}
        mode["block_q"] = min(mode["block_q"], Sq)
        mode["block_kv"] = min(mode["block_kv"], Skv)
        out, lse = ops._launch(q, k, v, with_lse=True, **mode)
        _, lse0 = ref.flash_mha_ref(q, k, v, return_lse=True, **mode)
        dead = torch.isinf(lse0)
        if not torch.equal(torch.isinf(lse), dead):
            raise AssertionError(f"{name}: rows that see nothing differ")
        err_lse = float((lse - lse0)[~dead].abs().max()) \
            if (~dead).any() else 0.0
        if not err_lse <= TOL_LSE:
            raise AssertionError(f"{name}: forward lse off by {err_lse}")
        path = ops.bwd_kernel_path(dtype, D)
        print(f"  {name}: forward {ops.kernel_path(dtype, D)}, lse |d| "
              f"{err_lse:.2g}, {int(dead.sum())} dead rows")
        got, err = backward(name, q, k, v, out, lse, dout, mode, path)
        errs = {path: err}
        if timed and path == "wgmma":
            # the CUDA-core kernel, which stays callable, on the same inputs
            _, errs["cuda_cores"] = backward(name, q, k, v, out, lse, dout,
                                             mode, "cuda_cores")
        if path == "wgmma":
            # the gap of the kernel's gradient to the fp32 gradient of the
            # plain forward (P kept in fp32 there; rounded to bf16 by the
            # tensor-core forward before P V and by this backward before
            # the products that take P and dS)
            q32, k32, v32 = (t.float() for t in (q, k, v))
            o32, l32 = ref.flash_mha_ref(q32, k32, v32, return_lse=True,
                                         **mode)
            exact = ref.flash_mha_bwd_ref(q32, k32, v32, o32, l32,
                                          dout.float(), **mode)
            gaps = [float((g.float() - w).abs().max()
                          / w.abs().max().clamp_min(1e-30))
                    for g, w in zip(got, exact)]
            print(f"    gap to the fp32 gradient of the plain forward "
                  f"(relative to each gradient's largest magnitude; limit "
                  f"{TOL_BWD_GAP:.3g}): dq {gaps[0]:.3g}, dk {gaps[1]:.3g}, "
                  f"dv {gaps[2]:.3g}")
            if not max(gaps) <= TOL_BWD_GAP:
                raise AssertionError(f"{name}: the tensor-core backward is "
                                     f"{max(gaps)} from the fp32 gradient")
            del q32, k32, v32, o32, l32, exact
        del got
        torch.cuda.empty_cache()
        if not timed:
            return errs, None
        times = {p_: cuda_ms(lambda: ops.flash_mha_bwd(
            q, k, v, out, lse, dout, path=p_, **mode), 5) for p_ in errs}
        plain = {rounding: cuda_ms(lambda: ref.flash_mha_bwd_ref(
            q, k, v, out, lse, dout, round_bf16=rounding, **mode), 1)
            for rounding in (False, True)}
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            o_sdpa = F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=mode["causal"])
        dot = dout.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            o_sdpa, (qt, kt, vt), dot, retain_graph=True), 5)
        vis = ref.visibility(Sq, Skv, **{a: x for a, x in mode.items()
                                         if a != "n_kv_heads"})
        pairs = Sq * Skv if vis is None else int(vis.sum())
        flops = 10.0 * B * Hq * pairs * D
        # q, k, v, o, dout and lse read once; dq, dk, dv written once
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
            + lse.numel() * 4
        t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"    backward: tensor cores {times['wgmma']:.3f} ms "
              f"({flops / times['wgmma'] / 1e9:.2f} TFLOP/s of the bound's "
              f"operations); CUDA cores {times['cuda_cores']:.3f} ms "
              f"({flops / times['cuda_cores'] / 1e9:.2f}); plain "
              f"{plain[True]:.3f} ms rounding, {plain[False]:.3f} ms "
              f"unrounded; SDPA backward (flash backend) {library_ms:.3f} "
              f"ms; bound {bound_ms:.3f} ms ({bound_by}; "
              f"{flops / 1e9:.1f} GFLOP, {pairs} visible pairs a head, "
              f"{nbytes / 1e6:.1f} MB)")
        del qt, kt, vt, o_sdpa
        torch.cuda.empty_cache()
        common = dict(bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=library_ms)
        return errs, {
            "wgmma": dict(ms=times["wgmma"], plain_ms=plain[True], **common),
            "cuda_cores": dict(ms=times["cuda_cores"], plain_ms=plain[False],
                               **common)}

    errs = {"wgmma": [], "cuda_cores": []}
    timing = {}
    # the two training shapes of phase 19 (bf16, tensor-core forward)
    for name, shape in BWD_TRAIN_SHAPES.items():
        B, Sq, Skv, H, D, causal = shape
        e, t = case(name, B, Sq, Skv, H, H, D, bf16, dict(causal=causal),
                    timed=True)
        for p_, x in e.items():
            errs[p_].append(x)
        timing[name] = t
        gc.collect()
        torch.cuda.empty_cache()
    # every mode at modest shapes: (name, B, Sq, Skv, Hq, Hkv, D, dtype,
    # keyword arguments)
    cases = [
        ("GQA G=4 causal D=128 bf16", 2, 512, 512, 16, 4, 128, bf16, {}),
        ("sink 77 + window 256 bf16", 1, 1024, 1024, 12, 12, 128, bf16,
         dict(window=256, sink=77)),
        ("rho 0.7 keep matrix 96 x 160 bf16", 1, 1920, 1920, 12, 12, 128,
         bf16, dict(sparsity=0.7, block_q=96, block_kv=160)),
        ("causal q_offset 1024 bf16", 2, 512, 1536, 12, 12, 128, bf16,
         dict(q_offset=1024)),
        ("whisper-medium 1,500 keys non-causal bf16", 2, 1500, 1500, 16, 16,
         64, bf16, dict(causal=False)),
        ("D=96 non-causal bf16 (causal-forcing)", 1, 660, 2057, 16, 16, 96,
         bf16, dict(causal=False)),
        ("rows that see nothing (window past the keys) fp32 D=16", 1, 64,
         40, 4, 2, 16, f32, dict(q_offset=32, window=16)),
        ("D=16 non-causal fp32 (reduced)", 2, 48, 269, 4, 4, 16, f32,
         dict(causal=False)),
        ("D=16 sink + window fp32", 1, 256, 256, 4, 4, 16, f32,
         dict(window=64, sink=16)),
        ("D=64 causal fp32", 1, 512, 512, 8, 8, 64, f32, {}),
        ("D=64 GQA 2 non-causal fp32", 2, 200, 333, 8, 4, 64, f32,
         dict(causal=False)),
    ]
    for name, b_, sq, skv, hq, hkv, d, dt, kw in cases:
        e, _ = case(name, b_, sq, skv, hq, hkv, d, dt, kw)
        for p_, x in e.items():
            errs[p_].append(x)
    torch.cuda.empty_cache()
    record.update(timing[BWD_MAIN]["cuda_cores"],
                  max_abs_err=max(errs["cuda_cores"]))
    record_tc.update(timing[BWD_MAIN]["wgmma"],
                     max_abs_err=max(errs["wgmma"]))
    return timing


def flash_train_launches(cfg, n_chunks=2):
    """Kernel 3's (forward, backward) launches of one train_loss and its
    backward: remat recomputes each checkpointed layer's forward; the
    AR-DiT (no remat) runs a noised and a clean pass per chunk, and the
    clean pass's last attention layer feeds only its discarded
    prediction (no backward), the last chunk's clean pass nothing."""
    if cfg.family == "ardit":
        L = cfg.n_layers
        return (2 * n_chunks * L, n_chunks * L + (n_chunks - 1) * (L - 1))
    if cfg.family == "encdec":
        return (cfg.n_enc_layers + 4 * cfg.n_dec_layers,
                cfg.n_enc_layers + 2 * cfg.n_dec_layers)
    return 2 * cfg.n_layers, cfg.n_layers


def phase_train():
    """Phase 19: training on the card.  (i) At the reduced configs, card
    against CPU on the same parameters and batch (loss and every gradient
    leaf), kernel 3's forward and backward launches checked against the
    layers; the SSD families raise the guard's error.  (ii) Full width
    through ``launch/train.py``'s ``main``: minicpm-2b and
    ardit-self-forcing, s/step, tokens/s, peak memory and kernel 3's
    launches per step, every backward on the tensor cores.  (iii) A
    checkpoint on the card: save, restore, continue, bit for bit (a bf16
    leaf included).  Returns (ii)'s results by arch and (i)'s backward
    launches (all on the CUDA cores)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import ardit as A
    from repro_torch.models import registry
    from repro_torch.models.convert import params_to
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop, optimizer as opt

    fm = flash_ops.flash_mha

    def reset_flash():
        fm.launches = fm.launches_tc = 0
        fm.launches_bwd = fm.launches_bwd_tc = 0

    print("  (i) reduced configs, card vs CPU (fp32, TF32 off)")
    parity_bwd = 0
    for arch in TRAIN_PARITY_ARCHS:
        cfg = get_config(arch).reduced()
        gen = torch.Generator().manual_seed(0)
        params = registry.get_api(cfg).init(cfg, gen, device="cpu")
        seq = 24
        if cfg.family == "ardit":
            params = A.open_gates(params, gen)
            seq = 2 * A.chunk_tokens(cfg)
        batch = dp.global_batch(cfg, ShapeConfig("t", "train", seq, 2), 0)
        loss_fn = loop.loss_for(cfg)
        l_cpu, g_cpu = loop.value_and_grad(loss_fn, params,
                                           loop.to_device(batch, "cpu"))
        reset_flash()
        l_card, g_card = loop.value_and_grad(
            loss_fn, params_to(params, DEV), loop.to_device(batch, DEV))
        sync()
        want_fwd, want_bwd = flash_train_launches(cfg)
        if (fm.launches, fm.launches_bwd) != (want_fwd, want_bwd):
            raise AssertionError(
                f"{arch}: kernel 3 launched {fm.launches} forward / "
                f"{fm.launches_bwd} backward, want {want_fwd} / {want_bwd}")
        if fm.launches_bwd_tc:
            raise AssertionError(f"{arch}: an fp32 backward on the tensor "
                                 f"cores")
        parity_bwd += fm.launches_bwd
        err_l = abs(float(l_card) - float(l_cpu))
        worst, where = 0.0, None
        cpu_leaves = dict(opt.leaves_with_path(g_cpu))
        for path, g in opt.leaves_with_path(g_card):
            w = cpu_leaves[path]
            rel_err = float((g.cpu() - w).abs().max()) / max(
                float(w.abs().max()), 1e-30)
            if rel_err > worst:
                worst, where = rel_err, "/".join(path)
        print(f"    {arch}: loss {float(l_card):.6f} (|d| to the CPU "
              f"{err_l:.3g}), worst gradient leaf {where} at {worst:.3g} of "
              f"its largest magnitude (limit {TOL_TRAIN:g}); kernel 3: "
              f"{fm.launches} forward, {fm.launches_bwd} backward launches")
        if not (err_l <= TOL_TRAIN * abs(float(l_cpu)) and
                worst <= TOL_TRAIN):
            raise AssertionError(f"{arch}: card gradients disagree with the "
                                 f"CPU's ({err_l}, {worst} at {where})")
    for arch in TRAIN_GUARDED_ARCHS:
        cfg = get_config(arch).reduced()
        params = registry.get_api(cfg).init(
            cfg, torch.Generator().manual_seed(0), device=DEV)
        batch = dp.global_batch(cfg, ShapeConfig("t", "train", 24, 2), 0)
        try:
            loop.value_and_grad(loop.loss_for(cfg), params,
                                loop.to_device(batch, DEV))
        except RuntimeError as e:
            if "has no backward" not in str(e):
                raise
            print(f"    {arch}: training raises the guard's error: {e}")
        else:
            raise AssertionError(f"{arch}: training through the SSD kernel "
                                 f"did not raise")

    print("  (ii) full width through launch/train.py")
    full = {}
    for arch, argv in TRAIN_FULL.items():
        gc.collect()
        torch.cuda.empty_cache()
        reset_flash()
        t0 = time.perf_counter()
        out = launch_train.main(argv)
        sync()
        wall = time.perf_counter() - t0
        cfg = get_config(arch)
        steps = len(out["loss"])
        args = launch_train.parse_args(argv)
        n_chunks = args.seq // A.chunk_tokens(cfg) \
            if cfg.family == "ardit" else 0
        want_fwd, want_bwd = flash_train_launches(cfg, n_chunks)
        per_fwd, per_bwd = fm.launches / steps, fm.launches_bwd / steps
        tokens = args.batch * args.seq
        warm = out["seconds"][1:]
        print(f"    {arch}: losses {[round(x, 4) for x in out['loss']]}; "
              f"s/step {[round(x, 3) for x in out['seconds']]} (after the "
              f"first: {sum(warm) / len(warm):.3f} s, "
              f"{tokens * len(warm) / sum(warm):.0f} tokens/s); peak "
              f"{max(out['peak_gib']):.2f} GiB; kernel 3 per step "
              f"{per_fwd:g} forward ({fm.launches_tc} of {fm.launches} on "
              f"the tensor cores), {per_bwd:g} backward "
              f"({fm.launches_bwd_tc} of {fm.launches_bwd} on the tensor "
              f"cores); {wall:.1f} s with the init")
        if (per_fwd, per_bwd) != (want_fwd, want_bwd):
            raise AssertionError(f"{arch}: kernel 3 per step {per_fwd} / "
                                 f"{per_bwd}, want {want_fwd} / {want_bwd}")
        if fm.launches_tc != fm.launches:
            raise AssertionError(f"{arch}: a bf16 forward off the tensor "
                                 f"cores")
        if fm.launches_bwd_tc != fm.launches_bwd:
            raise AssertionError(f"{arch}: a bf16 backward off the tensor "
                                 f"cores")
        if not all(np.isfinite(out["loss"]) & np.isfinite(out["grad_norm"])):
            raise AssertionError(f"{arch}: non-finite loss or gradient norm")
        full[arch] = dict(out, launches=fm.launches,
                          launches_bwd=fm.launches_bwd,
                          launches_bwd_tc=fm.launches_bwd_tc, tokens=tokens)
    losses = full["minicpm-2b"]["loss"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"minicpm-2b: the loss did not fall on one "
                             f"fixed batch ({losses})")
    gc.collect()
    torch.cuda.empty_cache()

    print("  (iii) checkpoint on the card (minicpm-2b reduced, bf16 params)")
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(),
                              param_dtype="bfloat16")
    params = registry.get_api(cfg).init(
        cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    state = loop.TrainState(params, opt.init_opt_state(params))
    step = loop.make_train_step(cfg, opt.OptConfig(lr=1e-3, warmup_steps=1,
                                                   total_steps=10))
    shape = ShapeConfig("t", "train", 32, 2)
    for s in range(2):
        state, _ = step(state, dp.global_batch(cfg, shape, s))
    with tempfile.TemporaryDirectory() as d:
        saved = [t.clone() for _, t in ckpt._flatten_with_names(state)]
        pending = ckpt.save(d, 2, state, blocking=False)
        state, _ = step(state, dp.global_batch(cfg, shape, 2))  # in place
        pending.join()
        fresh = registry.get_api(cfg).init(
            cfg, torch.Generator(device=DEV).manual_seed(1), device=DEV)
        back = ckpt.restore(d, ckpt.latest_step(d),
                            loop.TrainState(fresh, opt.init_opt_state(fresh)))
    leaves = [t for _, t in ckpt._flatten_with_names(back)]
    same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
        for a, b in zip(saved, leaves))
    n_bf16 = sum(t.dtype == torch.bfloat16 for t in leaves)
    # the step after the restore against the uninterrupted run's: within
    # a bf16 ulp of each leaf's largest magnitude (the embedding's
    # backward may add repeated tokens' rows in another order), printed
    # with whether it is bit for bit
    cont, _ = step(back, dp.global_batch(cfg, shape, 2))
    gaps = [float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), 1e-30)
            for (_, a), (_, b) in zip(opt.leaves_with_path(cont.params),
                                      opt.leaves_with_path(state.params))]
    print(f"    restored {len(leaves)} leaves ({n_bf16} bf16) bit for bit: "
          f"{same}; the step after it against the uninterrupted run's: "
          f"largest gap {max(gaps):.3g} of a leaf's magnitude (bit for bit: "
          f"{max(gaps) == 0.0})")
    if not (same and n_bf16 and max(gaps) <= 2.0 ** -8):
        raise AssertionError("checkpoint on the card: restore not bit for "
                             "bit, or the continued run diverged")
    return full, parity_bwd


def phase_sharded(train19):
    """Phase 20: the sharded steps on a 1x1 mesh of an NCCL group of
    world 1 (see the module docstring).  ``train19``: phase 19 (ii)'s
    results.  Returns the launches of kernels 3 and 4 in (i) and (ii)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.logical import P, logical_axis_rules
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.lowering import cache_shardings
    from repro_torch.models import registry
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import compression, loop, optimizer as opt

    fm, sd = flash_ops.flash_mha, ssd_ops.ssd
    pg_dir = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{pg_dir}/pg",
                            rank=0, world_size=1,
                            device_id=torch.device(DEV, 0))
    try:
        mesh = init_device_mesh(DEV, (1, 1), mesh_dim_names=("data", "model"))
        launches = {}

        print("  (i) minicpm-2b, phase 19's setup: 2 steps unsharded, then "
              "2 sharded")
        argv = TRAIN_FULL["minicpm-2b"]
        args = launch_train.parse_args(argv)
        cfg = get_config("minicpm-2b")
        api = registry.get_api(cfg)
        ocfg = opt.OptConfig(lr=args.lr, total_steps=max(args.steps, 10),
                             warmup_steps=max(2, args.steps // 10),
                             schedule="wsd")
        batch = loop.to_device(dp.global_batch(
            cfg, ShapeConfig("cli", "train", args.seq, args.batch), 0), DEV)

        def fresh():
            return api.init(cfg, torch.Generator(device=DEV).manual_seed(0),
                            device=DEV)

        gc.collect()
        torch.cuda.empty_cache()
        params = fresh()
        state = loop.TrainState(params, opt.init_opt_state(params))
        step = loop.make_train_step(cfg, ocfg)
        plain_loss = []
        for _ in range(2):
            state, m = step(state, batch)
            plain_loss.append(float(m["loss"]))
        want = dict(opt.leaves_with_path(tree_clone(state.params)))
        del state, params, m
        gc.collect()
        torch.cuda.empty_cache()
        sh = loop.state_shardings(cfg, mesh)
        params = shd.distribute(fresh(), sh.params)
        state = loop.TrainState(params, opt.init_opt_state(params))
        sstep = loop.make_sharded_train_step(cfg, ocfg, mesh)
        bd = shd.distribute(batch, loop.batch_shardings(cfg, mesh, batch))
        fm.launches = fm.launches_tc = 0
        fm.launches_bwd = fm.launches_bwd_tc = 0
        shard_loss, secs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            state, m = sstep(state, bd)
            shard_loss.append(float(m["loss"].full_tensor()))
            secs.append(time.perf_counter() - t0)
        got = dict(opt.leaves_with_path(state.params))
        same = all(torch.equal(got[k].to_local(), v) for k, v in want.items())
        checksum = sum(int(v.view(torch.int16).to(torch.int64).sum())
                       for v in want.values())
        want_fwd, want_bwd = flash_train_launches(cfg)
        w19 = train19["minicpm-2b"]["seconds"][1:]
        print(f"    losses unsharded {plain_loss}, sharded {shard_loss}, "
              f"phase 19 {train19['minicpm-2b']['loss'][:2]}; "
              f"{len(want)} parameters bit for bit: {same} (checksum "
              f"{checksum}); kernel 3 on the local tensors: {fm.launches} "
              f"forward ({fm.launches_tc} on the tensor cores), "
              f"{fm.launches_bwd} backward ({fm.launches_bwd_tc} on the "
              f"tensor cores); s/step {[round(x, 3) for x in secs]} "
              f"(phase 19 unsharded: {sum(w19) / len(w19):.3f})")
        if not (same and shard_loss == plain_loss
                == train19["minicpm-2b"]["loss"][:2]):
            raise AssertionError("minicpm-2b: the sharded steps differ from "
                                 "the unsharded ones")
        if (fm.launches, fm.launches_bwd) != (2 * want_fwd, 2 * want_bwd) \
                or fm.launches_tc != fm.launches \
                or fm.launches_bwd_tc != fm.launches_bwd:
            raise AssertionError(f"minicpm-2b sharded: kernel 3 launched "
                                 f"{fm.launches} / {fm.launches_bwd}, want "
                                 f"{2 * want_fwd} / {2 * want_bwd}, all on "
                                 f"the tensor cores")
        launches["flash_mha"] = fm.launches
        launches["flash_mha_bwd_tc"] = fm.launches_bwd_tc
        del state, params, got, want, m
        gc.collect()
        torch.cuda.empty_cache()

        print(f"  (ii) {SSM_ARCH} sharded prefill {SHARD_SERVE[0]} x "
              f"{SHARD_SERVE[1]} and {SHARD_DECODE_STEPS} decode steps")
        cfg = get_config(SSM_ARCH)
        api = registry.get_api(cfg)
        gen = torch.Generator().manual_seed(0)
        params = api.init(cfg, gen, DEV)
        tokens = torch.randint(0, cfg.vocab_size, SHARD_SERVE,
                               generator=gen).to(DEV)
        rows = shd.NamedSharding(mesh, P("data", None))
        pd = shd.distribute(params, shd.param_shardings(params, mesh,
                                                        serve=True))
        rules = shd.serve_rules(mesh)
        lg0, st0, n0 = api.prefill(cfg, params, tokens)
        sd.launches = sd.launches_tc = 0
        with logical_axis_rules(mesh, rules):
            lg1, st1, _ = api.prefill(cfg, pd, shd.distribute(tokens, rows))
        sync()
        prefill_launches = sd.launches
        same = [torch.equal(lg0, lg1.to_local())]
        cs = cache_shardings(cfg, mesh, st1)
        st1 = {k: v.redistribute(mesh, cs[k].placements)
               for k, v in st1.items()}
        pos = n0.clone()
        tok = torch.argmax(lg0, -1)[:, None].to(torch.int32)
        for _ in range(SHARD_DECODE_STEPS):
            lg0, st0 = api.decode_step(cfg, params, st0, tok, pos)
            with logical_axis_rules(mesh, rules):
                lg1, st1 = api.decode_step(
                    cfg, pd, st1, shd.distribute(tok, rows),
                    shd.distribute(pos, shd.NamedSharding(mesh, P("data"))))
            same.append(torch.equal(lg0, lg1.to_local()))
            tok = torch.argmax(lg0, -1)[:, None].to(torch.int32)
            pos = pos + 1
        same_state = all(torch.equal(st0[k], st1[k].to_local()) for k in st0)
        print(f"    prefill and {SHARD_DECODE_STEPS} decode steps bit for "
              f"bit: {same}, state {same_state}; kernel 4 on the local "
              f"heads: {prefill_launches} launches ({sd.launches_tc} on the "
              f"tensor cores) for {cfg.n_layers} layers")
        if not (all(same) and same_state):
            raise AssertionError(f"{SSM_ARCH}: sharded serving differs")
        if prefill_launches != cfg.n_layers or sd.launches != cfg.n_layers:
            raise AssertionError(f"{SSM_ARCH}: kernel 4 launched "
                                 f"{sd.launches}, want {cfg.n_layers}")
        launches["ssd"] = sd.launches
        del params, pd, st0, st1, lg0, lg1
        gc.collect()
        torch.cuda.empty_cache()

        print("  (iii) phase 19 (iii)'s checkpoint restored onto the mesh")
        cfg = dataclasses.replace(get_config("minicpm-2b").reduced(),
                                  param_dtype="bfloat16")
        params = registry.get_api(cfg).init(
            cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
        state = loop.TrainState(params, opt.init_opt_state(params))
        step = loop.make_train_step(cfg, opt.OptConfig(
            lr=1e-3, warmup_steps=1, total_steps=10))
        shape = ShapeConfig("t", "train", 32, 2)
        for i in range(2):
            state, _ = step(state, dp.global_batch(cfg, shape, i))
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, 2, state)
            back = ckpt.restore(d, 2, state,
                                shardings=loop.state_shardings(cfg, mesh))
        pairs = list(zip(ckpt._flatten_with_names(state),
                         ckpt._flatten_with_names(back)))
        same = all(type(b).__name__ == "DTensor" and torch.equal(
            bits(a), bits(b.to_local())) for (_, a), (_, b) in pairs)
        print(f"    {len(pairs)} leaves restored as DTensors bit for bit: "
              f"{same}")
        if not same:
            raise AssertionError("sharded restore differs from the saved "
                                 "state")

        print("  (iv) compressed_psum over the world-1 group")
        gen = torch.Generator(device=DEV).manual_seed(4)
        g = 1e-3 * torch.randn(COMPRESS_SHAPE, generator=gen, device=DEV)
        err = 1e-6 * torch.randn(COMPRESS_SHAPE, generator=gen, device=DEV)
        q, scale, want_err = compression.compress(g + err)
        want = compression.decompress(q, scale, g.shape, g.dtype)
        got, got_err = compression.compressed_psum(g, err)
        ms = cuda_ms(lambda: compression.compressed_psum(g, err), 5)
        print(f"    {tuple(g.shape)} fp32: bit for bit "
              f"{torch.equal(got, want) and torch.equal(got_err, want_err)}"
              f"; {ms:.3f} ms a call")
        if not (torch.equal(got, want) and torch.equal(got_err, want_err)):
            raise AssertionError("compressed_psum differs from "
                                 "decompress(compress(g + err))")
        return launches
    finally:
        dist.destroy_process_group()


def phase_examples(counters):
    """Phase 21: the examples on the card (see the module docstring).
    Returns kernel 3's (forward, backward) launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.examples import quickstart, train_small
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.convert import params_to

    fm = flash_ops.flash_mha

    def read(label, want_fwd, want_bwd):
        got = {n: fn.launches for n, fn in counters.items()}
        want = {**{n: 0 for n in counters}, "flash_mha": want_fwd}
        if got != want or (fm.launches_bwd, fm.launches_tc,
                           fm.launches_bwd_tc) != (want_bwd, 0, 0):
            raise AssertionError(
                f"{label}: launches {got}, flash backward "
                f"{fm.launches_bwd}, on the tensor cores {fm.launches_tc} / "
                f"{fm.launches_bwd_tc}; expected {want}, backward "
                f"{want_bwd}, none on the tensor cores (fp32)")
        print(f"  {label}: kernel 3 launched {want_fwd} forward and "
              f"{want_bwd} backward, on the CUDA cores")

    cfg = get_config("ardit-self-forcing").reduced()
    reset_counts(counters)
    fm.launches_bwd = fm.launches_bwd_tc = 0
    t0 = time.perf_counter()
    chunks = quickstart.main(["--device", DEV])
    sync()
    sec_q = time.perf_counter() - t0
    q_fwd = cfg.n_layers * sum(f.steps + 1 for f in quickstart.FIDELITIES)
    read("quickstart", q_fwd, 0)
    params, cond, noise = quickstart.model_inputs(cfg, torch.device(DEV))
    cpu = quickstart.generate_chunks(cfg, params_to(params, "cpu"),
                                     cond.cpu(), noise.cpu())
    for chunk, (fid, want, _) in zip(chunks, cpu):
        err = float((chunk.cpu() - want).abs().max())
        print(f"  quickstart chunk at {fid.key}: card vs CPU max |d| "
              f"{err:.3g} (limit {TOL_CARD_CPU:g})")
        if tuple(chunk.shape) != tuple(want.shape) or not err <= TOL_CARD_CPU:
            raise AssertionError(f"quickstart chunk at {fid.key}: card vs "
                                 f"CPU {err}")
    print(f"  quickstart: {sec_q:.1f} s")

    tcfg = get_config("minicpm-2b").reduced()
    reset_counts(counters)
    fm.launches_bwd = fm.launches_bwd_tc = 0
    t0 = time.perf_counter()
    out = train_small.main(["--device", DEV])
    sync()
    sec_t = time.perf_counter() - t0
    calls = 2 * len(out["straight_losses"]) * train_small.MICROBATCHES
    per_fwd, per_bwd = flash_train_launches(tcfg)
    read("train_small", calls * per_fwd, calls * per_bwd)
    losses = out["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train_small losses {losses}")
    print(f"  train_small: {len(losses)} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, the resumed run bit for bit with the "
          f"uninterrupted one; {sec_t:.1f} s")
    return q_fwd + calls * per_fwd, calls * per_bwd


def tree_clone(tree):
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    return tree.clone()


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


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

    # (name, B, S, H, P, N, chunk, dtype, init_state, strided views);
    # hg16: the (64, 16) kernel's heads per block
    hg16 = ops.TC_BLOCKING[16][0]
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
        # jamba-v0.1-52b's (P, N) = (64, 16) on its tensor-core kernel
        ("ragged S=1000 bf16 (P 64, N 16)", 2, 1000, H, P, 16, Q, bf16,
         False, False),
        ("S=100 < chunk bf16 (P 64, N 16)", 2, 100, H, P, 16, Q, bf16,
         False, False),
        ("init_state S=1000 bf16 (P 64, N 16)", 2, 1000, H, P, 16, Q, bf16,
         True, False),
        ("strided views with init_state S=1000 bf16 (P 64, N 16)", 2, 1000,
         H, P, 16, Q, bf16, True, True),
        (f"chained grid of {2 * -(-13243 // Q) * -(-H // hg16):,} blocks "
         f"B=2 S=13,243 bf16 (P 64, N 16)", 2, 13243, H, P, 16, Q, bf16,
         True, True),
        (f"partial head group H={hg16 + 3} chunk 64 bf16 (P 64, N 16)", 2,
         1000, hg16 + 3, P, 16, 64, bf16, False, True),
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
    del x, dt, A, Bm, Cm, s0
    torch.cuda.empty_cache()

    # jamba-v0.1-52b's Mamba sublayers at full width, x/B/C the model's
    # views of the conv output: (P, N) = (64, 16) on the tensor cores,
    # then its CUDA-core passes at the same shape (the row's earlier time)
    B, H, P, N = SSM_PREFILL[0], 128, 64, 16
    x, dt, A, Bm, Cm, _ = ssd_case(gen, B, S, H, P, N, bf16, view=True)
    name = f"jamba-v0.1-52b B={B} S={S} H={H} P={P} N={N} bf16"

    def jamba(path=None):
        return ops.ssd(x, dt, A, Bm, Cm, chunk=Q, path=path)

    want = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=Q)
    got = on_path(name, jamba, "wgmma")
    errs.append(compare_ssd(f"{name} (wgmma)", got, want))
    again = jamba()
    if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
        raise AssertionError(f"{name}: two calls differ")
    del got, again
    errs.append(compare_ssd(f"{name} (cuda_cores)", on_path(
        name, lambda: jamba("cuda_cores"), "cuda_cores"), want))
    del want
    kernel_ms = cuda_ms(jamba, 10)
    core_ms = cuda_ms(lambda: jamba("cuda_cores"), 10)
    plain_ms = cuda_ms(lambda: ref.ssd_ref(x, dt, A, Bm, Cm, chunk=Q), 2)
    flops = ssd_flops(B, S, H, P, N, Q)
    nbytes = (2 * B * S * H * P * 2 + dt.numel() * 4 + H * 4
              + 2 * B * S * N * 2 + B * H * P * N * 4)
    t_ops = flops / PEAK_FLOPS["torch.bfloat16"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  {name}: kernel (wgmma, {hg16} heads a block, "
          f"{ops.TC_BLOCKING[16][1]} blocks an SM) {kernel_ms:.3f} ms, "
          f"CUDA-core passes {core_ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {max(t_ops, t_bytes):.3f} ms ("
          f"{'operations' if t_ops >= t_bytes else 'bytes'}; "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), achieved "
          f"{flops / kernel_ms / 1e9:.2f} TFLOP/s, "
          f"{nbytes / kernel_ms / 1e6:.0f} GB/s")
    if not kernel_ms < core_ms:
        raise AssertionError(f"{name}: the tensor-core kernel "
                             f"({kernel_ms:.3f} ms) is not faster than the "
                             f"CUDA-core passes ({core_ms:.3f} ms)")
    del x, dt, A, Bm, Cm
    torch.cuda.empty_cache()
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


# phase 16: the token families at full width.  Per model: its config
# replacements (depth cut), the timed prefill (B, S) at the config's own
# MoE capacity and its decode steps, then the consistency gates: (B,
# total length, capacity factor or None, param dtype, depth cut).  A gate
# prefills the total less GATE_STEPS tokens, decodes GATE_STEPS greedy
# steps and prefills the whole again, teacher-forced: both prefills are
# multiples of the attention schedule's 512-token blocks, as ``mha``
# requires.  The fp32 gates keep the first quarter of each layer stack
# (32 -> 8, 24 -> 6, 24 + 24 -> 6 + 6) at full width, GATE_STEPS and
# their limit: they hold the fp32 arithmetic of one layer, which more
# layers only repeat, and their host-bound decode loops were the chip
# check's longest (an earlier path's depth is cut first when the script
# grows); the bf16 gates keep the timed runs' depth.
FAMILY_MODELS = [
    ("minitron-8b", {}, (2, 32768), 32,
     [(2, 32768, None, "bfloat16", {}),
      (2, 4096, None, "float32", {"n_layers": 8})]),
    ("granite-moe-1b-a400m", {}, (2, 32768), 32,
     [(2, 32768, 8.0, "bfloat16", {}),
      (2, 4096, 8.0, "float32", {"n_layers": 6})]),
    ("internvl2-26b", {}, (1, 8192), 16, [(1, 8192, None, "bfloat16", {})]),
    # one period of 8 sublayers of 4 (104 GB in bf16 whole), every width
    # as published
    ("jamba-v0.1-52b", {"n_layers": 8}, (2, 32768), 32,
     [(1, 12288, 8.0, "bfloat16", {})]),
    # 24 encoder + 24 decoder layers over 1,500 stub audio frames
    ("whisper-medium", {}, (2, 32768), 32,
     [(2, 32768, None, "bfloat16", {}),
      (2, 4096, None, "float32", {"n_enc_layers": 6, "n_dec_layers": 6})]),
]
# the stacked layer trees of each family's params, by the config field
# that counts them
LAYER_STACKS = {"layers": "n_layers", "enc_layers": "n_enc_layers",
                "dec_layers": "n_dec_layers"}
GATE_STEPS = 512


class FamilyRun:
    """Phase 16 for one model of ``FAMILY_MODELS``: its config, params,
    expected launches per prefill and the runs that check them."""

    def __init__(self, arch, cut, counters, totals):
        from repro_torch.configs.base import get_config
        from repro_torch.models import hybrid, registry

        self.arch, self.counters, self.totals = arch, counters, totals
        full = get_config(arch)
        self.cfg = cfg = dataclasses.replace(full, **cut)
        self.api = registry.get_api(cfg)
        self.n_attn, self.n_ssd, self.n_decode_attn = family_launches(cfg)
        if cfg.family == "hybrid":
            kinds = hybrid.sublayer_kinds(cfg)
            print(f"  {arch}: depth cut to {cfg.n_layers} of "
                  f"{full.n_layers} layers "
                  f"({cfg.n_layers // hybrid.period_len(cfg)} period: "
                  f"{self.n_attn} attention, {self.n_ssd} Mamba, "
                  f"{sum(f == 'moe' for _, f in kinds)} MoE of "
                  f"{cfg.n_experts} x top {cfg.top_k}, "
                  f"{sum(f == 'mlp' for _, f in kinds)} MLP sublayers); "
                  f"every width as published")
        elif cfg.family == "encdec":
            print(f"  {arch}: {cfg.n_enc_layers} encoder + "
                  f"{cfg.n_dec_layers} decoder layers over "
                  f"{cfg.n_frontend_tokens} stub audio frames")
        t0 = time.perf_counter()
        self.gen = torch.Generator(device=DEV).manual_seed(0)
        self.params = self.api.init(cfg, self.gen, DEV)
        sync()
        n = sum(t.numel() for t in _leaves(self.params))
        print(f"  {arch}: {n / 1e9:.3f} B params ({cfg.param_dtype}, "
              f"{n * 2 / 2**30:.2f} GiB), init "
              f"{time.perf_counter() - t0:.1f} s")

    def inputs(self, cfg, b, s):
        """Random tokens and, for a VLM, image embeddings: s positions in
        all; for an encoder-decoder also its stub audio frames."""
        n_img = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
        stub = {"vlm": "img_embeds", "encdec": "audio_embeds"}.get(
            cfg.family)
        kw = {}
        if stub:
            kw[stub] = (0.02 * torch.randn(
                (b, cfg.n_frontend_tokens, cfg.d_model), generator=self.gen,
                device=DEV)).to(self.params["embed"].dtype)
        return torch.randint(0, cfg.vocab_size, (b, s - n_img),
                             generator=self.gen, device=DEV), kw

    def prefill(self, label, cfg, tokens, kw, max_len):
        """One prefill with the launch counts checked: the attention
        layers' flash launches and the Mamba sublayers' SSD launches (on
        the tensor cores in bf16), nothing else."""
        tc = cfg.param_dtype == "bfloat16"
        n_attn, n_ssd, _ = family_launches(cfg)
        reset_counts(self.counters)
        sync()
        t0 = time.perf_counter()
        out = self.api.prefill(cfg, self.params, tokens, max_len=max_len,
                               **kw)
        sync()
        sec = time.perf_counter() - t0
        got = {n: fn.launches for n, fn in self.counters.items()}
        want = {**{n: 0 for n in self.counters}, "flash_mha": n_attn,
                "ssd": n_ssd}
        tcs = (self.counters["flash_mha"].launches_tc,
               self.counters["ssd"].launches_tc)
        if got != want or tcs != ((n_attn, n_ssd) if tc else (0, 0)):
            raise AssertionError(f"{label} prefill: launches {got}, on the "
                                 f"tensor cores {tcs}; expected {want}")
        if tc:
            self.totals["flash_mha"] += n_attn
            self.totals["ssd"] += n_ssd
        else:
            self.totals["flash_mha_f32"] += n_attn
        if tuple(out[0].shape) != (tokens.shape[0], cfg.padded_vocab) \
                or not bool(torch.isfinite(out[0]).all()):
            raise AssertionError(f"{label} prefill: bad logits")
        return out, sec

    def decode(self, label, cfg, logits, cache, pos, n, trace=None):
        """``n`` greedy decode steps, launching only an encoder-decoder's
        cross-attention (flash, one per decoder layer a step, on the
        tensor cores in bf16); with ``trace``, the routing of the last
        step's token is recorded there."""
        reset_counts(self.counters)
        generated, ms = [], []
        for i in range(n):
            tok = logits[:, :cfg.vocab_size].argmax(-1)[:, None]
            generated.append(tok)
            if trace is not None and i == n - 1:
                trace["routes"] = []
            sync()
            t0 = time.perf_counter()
            logits, cache = self.api.decode_step(cfg, self.params, cache,
                                                 tok, pos)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            pos = pos + 1
        got = {n_: fn.launches for n_, fn in self.counters.items()}
        want = {**{n_: 0 for n_ in self.counters},
                "flash_mha": family_launches(cfg)[2] * n}
        tc = self.counters["flash_mha"].launches_tc
        if got != want or tc != (want["flash_mha"]
                                 if cfg.param_dtype == "bfloat16" else 0):
            raise AssertionError(f"{label} decode: launches {got}, flash on "
                                 f"the tensor cores {tc}; expected {want}")
        if cfg.param_dtype == "bfloat16":
            self.totals["flash_mha_decode"] += want["flash_mha"]
        else:
            self.totals["flash_mha_f32"] += want["flash_mha"]
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{label} decode: non-finite logits")
        return logits, generated, ms

    def timed(self, B, S, steps):
        """Prefill B x S at the config's own capacity, then ``steps``
        greedy decode steps: tokens/s and ms per token."""
        cfg = self.cfg
        label = f"{self.arch} {cfg.param_dtype}"
        tokens, kw = self.inputs(cfg, B, S)
        (logits, cache, pos), sec = self.prefill(label, cfg, tokens, kw,
                                                 S + steps)
        _, _, ms = self.decode(label, cfg, logits, cache, pos, steps)
        print(f"  {label} prefill B={B} S={S}: {sec:.3f} s "
              f"({B * S / sec:.0f} tokens/s); decode B={B}: {steps} greedy "
              f"steps from position {S}, first {ms[0]:.2f} ms, then "
              f"{sum(ms[1:]) / (steps - 1):.2f} ms per token (step)")

    def gate(self, B, total, cap_factor, dtype, depth, trace):
        """The last of GATE_STEPS decode steps against a teacher-forced
        prefill of the same tokens: relative L2 of the logits within
        TOL_CONSISTENCY (bf16; where the two paths routed the compared
        token differently, TOL_CONSISTENCY_FLIP and half the gap to
        another position's logits) or TOL_CONSISTENCY_F32.  ``depth``:
        config replacements that keep the first layers of each stack
        (the params' stacks are cut to match; every later gate of the
        model runs on the cut params)."""
        from repro_torch.models import layers as L

        cfg = self.cfg
        if cap_factor is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cap_factor)
        if depth:
            cfg = dataclasses.replace(cfg, **depth)
            self.params = {
                k: L.tree_map(lambda t: t[:getattr(cfg, LAYER_STACKS[k])],
                              v) if k in LAYER_STACKS else v
                for k, v in self.params.items()}
        if dtype != cfg.param_dtype:
            # the same weights widened: the two paths then differ in fp32
            # summation order only
            cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                      kv_dtype=dtype)
            self.params = L.tree_map(lambda t: t.float(), self.params)
        label = f"{self.arch} {dtype}" + (
            f" capacity {cap_factor:g}" if cap_factor else "") + (
            ", first " + " + ".join(f"{getattr(cfg, f)} of "
                                    f"{getattr(self.cfg, f)}"
                                    for f in LAYER_STACKS.values()
                                    if f in depth) + " layers"
            if depth else "")
        tokens, kw = self.inputs(cfg, B, total)
        head = tokens[:, :tokens.shape[1] - GATE_STEPS]
        (logits, cache, pos), sec_p = self.prefill(label, cfg, head, kw,
                                                   total)
        first = logits
        logits, generated, ms = self.decode(label, cfg, logits, cache, pos,
                                            GATE_STEPS, trace)
        routes, trace["routes"] = trace["routes"], []
        del cache
        (tf, _, _), sec = self.prefill(f"{label} teacher-forced", cfg,
                                       torch.cat([head] + generated, 1), kw,
                                       None)
        tf_routes, trace["routes"] = trace["routes"], None
        flips = [j for j, (a, b) in enumerate(zip(routes, tf_routes))
                 if not torch.equal(a, b)]
        other = rel(first, tf)
        if dtype != "bfloat16":
            limit = TOL_CONSISTENCY_F32
        elif flips:
            limit = max(TOL_CONSISTENCY,
                        min(TOL_CONSISTENCY_FLIP, other / 2))
        else:
            limit = TOL_CONSISTENCY
        gap = rel(logits, tf)
        agree = float((logits.argmax(-1) == tf.argmax(-1)).float().mean())
        flip_note = (f"; the compared token routed differently in MoE "
                     f"sublayer(s) {flips} of {len(routes)}" if flips else
                     (f"; the same experts in all {len(routes)} MoE "
                      f"sublayers" if routes else ""))
        print(f"  {label} gate B={B}: prefill {total - GATE_STEPS} "
              f"({sec_p:.3f} s), {GATE_STEPS} greedy steps "
              f"({sum(ms) / len(ms):.2f} ms per token), teacher-forced "
              f"prefill {total} ({sec:.3f} s, {B * total / sec:.0f} "
              f"tokens/s): last decode logits vs it: relative L2 {gap:.4g} "
              f"(limit {limit:g}){flip_note}, greedy token agrees for "
              f"{agree:.0%} of rows; another position's logits vs it: "
              f"relative L2 {other:.4g}")
        if not gap <= limit:
            raise AssertionError(f"{label}: prefill/decode gap {gap}")


def family_launches(cfg):
    """Kernel launches of one prefill of ``cfg`` (flash: the attention
    layers; ssd_scan: the Mamba sublayers) and flash launches of one
    decode step (only an encoder-decoder's cross-attention: every
    family's decode self-attention is the plain one)."""
    from repro_torch.models import hybrid

    if cfg.family == "hybrid":
        kinds = hybrid.sublayer_kinds(cfg)
        n_periods = cfg.n_layers // hybrid.period_len(cfg)
        return (n_periods * sum(m == "attn" for m, _ in kinds),
                n_periods * sum(m == "mamba" for m, _ in kinds), 0)
    if cfg.family == "encdec":
        # encoder self-attention, decoder causal self-attention and
        # cross-attention per prefill; a decode step's cross-attention
        return cfg.n_enc_layers + 2 * cfg.n_dec_layers, 0, cfg.n_dec_layers
    return cfg.n_layers, 0, 0


def rel(a, b):
    """Relative L2 distance of ``a`` from ``b``."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_families(counters):
    """Phase 16: ``FAMILY_MODELS`` at full width through the registry
    API, random weights from a seed (see ``FamilyRun``): flash launches =
    the attention layers per prefill, all on the tensor cores in bf16
    and on the CUDA cores in fp32; ssd_scan launches = the Mamba
    sublayers per prefill, on the tensor cores in bf16 ((P, N) = (64,
    16));
    from decode only an encoder-decoder's cross-attention (one flash
    launch per decoder layer a step).  Returns the flash launches of the
    bf16 prefills and of the bf16 decode steps, and the ssd launches."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import layers as L

    totals = {"flash_mha": 0, "flash_mha_decode": 0, "ssd": 0,
              "flash_mha_f32": 0}
    # while a list: the experts each MoE sublayer routes the last token to
    trace = {"routes": None}
    route = L.moe_route

    def traced_route(cfg, p, x):
        out = route(cfg, p, x)
        if trace["routes"] is not None:
            trace["routes"].append(out[1][:, -1].sort(-1).values)
        return out

    L.moe_route = traced_route
    try:
        for arch, cut, (B, S), steps, gates in FAMILY_MODELS:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run = FamilyRun(arch, cut, counters, totals)
            run.timed(B, S, steps)
            for gate in gates:
                run.gate(*gate, trace)
            cfg = run.cfg
            ssd_path = ssd_ops.kernel_path(
                torch.bfloat16, cfg.ssm_head_dim, cfg.ssm_state) \
                if run.n_ssd else "none"
            print(f"  {arch}: peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"flash launches {run.n_attn} per prefill and "
                  f"{run.n_decode_attn} per decode step ("
                  f"{flash_ops.kernel_path(torch.bfloat16, cfg.head_dim)} "
                  f"in bf16, "
                  f"{flash_ops.kernel_path(torch.float32, cfg.head_dim)} "
                  f"in fp32), ssd_scan {run.n_ssd} per prefill "
                  f"({ssd_path})")
            del run
    finally:
        L.moe_route = route
    print(f"  phase 16: {totals['flash_mha']} flash launches in the bf16 "
          f"prefills and {totals['flash_mha_decode']} in the bf16 decode "
          f"steps (whisper-medium's cross-attention), all on the tensor "
          f"cores; {totals['flash_mha_f32']} in the fp32 gates, on the "
          f"CUDA cores; {totals['ssd']} ssd_scan launches, on the tensor "
          f"cores")
    gc.collect()
    torch.cuda.empty_cache()
    return totals


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


def force_migration_and_sp(sess):
    """Force one migration of stream 0 (after its first chunk) and one SP
    expand of stream 1 (after its first chunk) and its release (after
    its second) through the session's own tick -> apply path."""
    from repro_torch.core.elastic_sp import SPDecision
    from repro_torch.core.rehoming import Migration

    pool = sess.lanes
    state = {"mig": False, "sp": False, "rel": False}
    orig_tick = sess.control.tick

    def tick(view, now):
        d = orig_tick(view, now)
        s0, s1 = view.streams.get(0), view.streams.get(1)
        if (not state["mig"] and s0 is not None and s0.chunks_done >= 1
                and not s0.done and not pool.is_inflight(0)):
            src = pool.lane_of[0]
            d.migrations.append(Migration(0, src, 1 - src,
                                          cross_node=False))
            state["mig"] = True
        if (not state["sp"] and s1 is not None and s1.chunks_done >= 1
                and not s1.done
                and pool.ex(pool.lane_of[1]).pool.resident(1)):
            d.sp_decisions.append(SPDecision(1, 1 - pool.lane_of[1],
                                             "expand"))
            state["sp"] = True
        elif (state["sp"] and not state["rel"] and s1 is not None
                and not s1.done and s1.sp_donor is not None
                and s1.chunks_done >= 2):
            d.sp_decisions.append(SPDecision(1, s1.sp_donor, "release"))
            state["rel"] = True
        return d

    sess.control.tick = tick


def phase_lanes(cfg, params, counters):
    """Phase 10: elastic SP and migration at full width, two lanes on
    the one card; see the module docstring."""
    from repro_torch.core.bmpr import StaticFidelity
    from repro_torch.core.fidelity import FidelityConfig
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
    lanes.sp_mode = "auto"

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
            force_migration_and_sp(sess)
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


def bf16_p_segment(tc):
    """``attention._segment_attn`` with the probabilities of the context
    (every key but the chunk's own ``tc``) rounded to bf16 before P V and
    their sum kept in fp32, as kernel 1 treats them (``paged_mha``'s
    in-chunk segment stays fp32)."""
    import math

    def segment(q, k, v, mask, scale):
        s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
        if mask is not None:
            mask = mask[None, None, None] if mask.ndim == 2 \
                else mask[:, None, None]
            s = torch.where(mask, s, -math.inf)
        m = torch.amax(s, dim=-1)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.exp(s - m_safe[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        l = torch.sum(p, dim=-1)
        n = k.shape[1] - tc
        p[..., :n] = p[..., :n].to(torch.bfloat16).float()
        return m_safe, l, torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())

    return segment


def phase_ring(cfg, params, counters):
    """Phase 17: the ring batched cache at full width on phase 5's
    weights.  The batched paged executor serves 2 streams x 2 chunks at
    top fidelity, then one fp8 chunk each (both rows in every step).
    (i) Per chunk, from the same cache: before each of its chunks the
    pool's pages are assembled into the ring layout (``KVPool.gather``)
    and ``serve_chunk_batched`` serves the chunk from that ring with the
    same noise (the reference's paged-vs-ring test, in bf16 at full
    width, where kernel 1 stands against the plain masked segment), then
    again with the context's P rounded to bf16 (``bf16_p_segment``): the
    latents' gap to the executor's within RING_SENSITIVITY_FACTOR times
    the gap that rounding makes, and at least within ``TOL_RING_REL``;
    the ring outside the chunk's new slot unchanged, the new slot's KV
    gap printed.
    (ii) The ring on its own from ``init_batched_cache``: each chunk's
    KV feeds the next, so the gaps grow chunk by chunk; printed, not
    gated.  The ring path launches no kernel (the plain masked segment,
    as the reference runs it on the TPU too)."""
    from repro_torch.models import ardit as A
    from repro_torch.models import attention, kvcache
    from repro_torch.serve.batcher import BatchedChunkExecutor
    from repro_torch.serve.executor import chunk_noise, cond_noise

    segment_attn = attention._segment_attn
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sids = (0, 1)
    fids = (A.HIGHEST_QUALITY, A.HIGHEST_QUALITY,
            A.HIGHEST_QUALITY._replace(quant="fp8"))
    tc, w = A.chunk_tokens(cfg), cfg.ardit_window_chunks
    ex = BatchedChunkExecutor(cfg=cfg, params=params, max_streams=2,
                              device=DEV)
    for sid in sids:
        ex.admit(sid, seed=sid)

    def noise_of(c):
        return torch.cat([chunk_noise(c, sid, tc) for sid in sids]).to(DEV)

    worst, paged_s, ring_s = 0.0, 0.0, []
    for c, fid in enumerate(fids):
        k0, v0 = ex.pool.gather(list(sids), w)
        chunks = np.asarray([ex.pool.chunks[sid] for sid in sids])
        sync()
        t0 = time.perf_counter()
        for sid in sids:
            ex.begin_chunk(sid, fid, 0.0)
        while ex.inflight:
            ex.run_step(list(sids))
        sync()
        paged_s += time.perf_counter() - t0
        reset_counts(counters)
        ring = {"k": k0.clone(), "v": v0.clone(), "chunks": chunks}
        t0 = time.perf_counter()
        x, ring = A.serve_chunk_batched(cfg, params, ring, noise_of(c), fid)
        sync()
        ring_s.append(time.perf_counter() - t0)
        if any(fn.launches for fn in counters.values()):
            raise AssertionError("the ring path launched a kernel")
        attention._segment_attn = bf16_p_segment(tc)
        try:
            x_p, _ = A.serve_chunk_batched(
                cfg, params, {"k": k0, "v": v0, "chunks": chunks},
                noise_of(c), fid)
        finally:
            attention._segment_attn = segment_attn
        pk, pv = ex.pool.gather(list(sids), w)
        slots = kvcache.chunk_slot(chunks, w, A.COND_TOKENS, tc)
        for i, sid in enumerate(sids):
            want = ex.chunks[sid][c][0]
            gap, sens = rel(x[i], want), rel(x_p[i], x[i])
            limit = max(TOL_RING_REL, RING_SENSITIVITY_FACTOR * sens)
            worst = max(worst, gap / limit)
            lo = int(slots[i])
            kv_gap = max(rel(ring[n][:, i, lo:lo + tc], p[:, i, lo:lo + tc])
                         for n, p in (("k", pk), ("v", pv)))
            kept = all(torch.equal(ring[n][:, i, :lo], p[:, i, :lo])
                       and torch.equal(ring[n][:, i, lo + tc:],
                                       p[:, i, lo + tc:])
                       for n, p in (("k", pk), ("v", pv)))
            print(f"  (i) chunk {c} ({fid.key}), stream {sid}, from the "
                  f"pool's context: latents relative L2 {gap:.4g} (limit "
                  f"{limit:.4g}: the ring's own gap with P rounded to bf16 "
                  f"{sens:.4g}, x {RING_SENSITIVITY_FACTOR:g}, at least "
                  f"{TOL_RING_REL:.4g}); new slot {lo}: KV relative L2 "
                  f"{kv_gap:.4g}; rest of the ring "
                  f"{'unchanged' if kept else 'CHANGED'}")
            if not kept:
                raise AssertionError(f"the ring write of chunk {c} touched "
                                     f"slots outside {lo}..{lo + tc}")
            if not gap <= limit:
                raise AssertionError(f"ring vs paged, chunk {c} stream "
                                     f"{sid}: relative L2 {gap} > {limit}")
        del k0, v0, pk, pv, ring, x_p
        gc.collect()
        torch.cuda.empty_cache()
    paged = {sid: list(ex.chunks[sid]) for sid in sids}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del ex
    gc.collect()
    torch.cuda.empty_cache()

    reset_counts(counters)
    cond = torch.cat([cond_noise(sid, cfg.d_model) for sid in sids]).to(DEV)
    ring = A.init_batched_cache(cfg, params, cond)
    for c, fid in enumerate(fids):
        x, ring = A.serve_chunk_batched(cfg, params, ring, noise_of(c), fid)
        if tuple(x.shape) != (2, tc, A.LATENT_CH) or \
                not bool(torch.isfinite(x).all()):
            raise AssertionError(f"ring chunk {c}: bad latents")
        print(f"  (ii) the ring on its own, chunk {c} ({fid.key}): "
              f"latents vs the executor's, relative L2 "
              + ", ".join(f"stream {sid} {rel(x[i], paged[sid][c][0]):.4g}"
                          for i, sid in enumerate(sids))
              + f" (not gated; another stream's chunk: "
              f"{rel(x[1], paged[0][c][0]):.4g})")
    got = {n: fn.launches for n, fn in counters.items()}
    if any(got.values()) or list(ring["chunks"]) != [len(fids)] * 2:
        raise AssertionError(f"ring: launches {got}, chunks "
                             f"{ring['chunks']}")
    print(f"  ring: 2 streams x {len(fids)} chunks in "
          f"{', '.join(f'{t:.2f}' for t in ring_s)} s a chunk (the plain "
          f"masked segment over the {A.cache_capacity(cfg)}-token ring, no "
          f"kernel launched); the paged executor took {paged_s:.2f} s for "
          f"the same chunks; peak memory {peak:.2f} GiB; worst gap from the "
          f"same context {worst:.3f} of its limit")
    del ring, paged
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def phase_device_pair(cfg, params, counters):
    """Phase 10 (iii): lanes on different devices, a lane on the card
    beside a lane on the CPU (``LanePool(devices=[cuda, cpu])``).  At
    full width (phase 5's weights): a stream with 2 chunks of context
    migrates card -> CPU -> card, each a measured PCIe move whose pages
    arrive bit for bit.  At the reduced config (fp32, TF32 off, gates
    opened): batch-axis SP (``sp_mode="auto"`` takes it for the pair) with
    the guest on the CPU lane against the never-borrowed stream on the
    card, and a 2-device session that migrates one stream and borrows
    another against a 1-lane session on the card, within
    ``TOL_CARD_CPU``."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core.bmpr import StaticFidelity
    from repro_torch.core.fidelity import FidelityConfig
    from repro_torch.models import ardit as A
    from repro_torch.serve.batcher import BatchedChunkExecutor
    from repro_torch.serve.lanes import LanePool
    from repro_torch.serve.session import (SessionConfig, StreamingSession,
                                           uniform_specs)

    pair = [DEV, "cpu"]
    fid = FidelityConfig(2, 0.0, 2, "bf16")

    def chunks(ex, sid, n, f=fid):
        out = []
        for _ in range(n):
            ex.begin_chunk(sid, f, 0.0)
            while sid in ex.inflight:
                ex.run_step([sid])
            out.append(ex.chunks[sid][-1].cpu())
        return out

    # ---- full width: measured PCIe migrations -----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    lp = LanePool(2, cfg=cfg, params=params, max_streams=1, devices=pair)
    lp.admit(0, 0, seed=0)
    chunks(lp.ex(0), 0, 2, FidelityConfig(2, 0.0, 7, "bf16"))
    for src, dst in ((0, 1), (1, 0)):
        ctx = [t.cpu() for t in lp.ex(src).pool.gather([0], 2)]
        n = len(lp.engine.measured)
        if not lp.migrate(0, src, dst):
            raise AssertionError("migration across the pair not applied")
        (m,) = lp.engine.measured[n:]
        got = [t.cpu() for t in lp.ex(dst).pool.gather([0], 2)]
        if m.kind != "migration" or not lp.ex(dst).pool.resident(0) or \
                not all(torch.equal(a, b) for a, b in zip(got, ctx)):
            raise AssertionError("the migrated pages differ")
        print(f"  full-width migration {lp.lane_devices[src].type} -> "
              f"{lp.lane_devices[dst].type}: pages bit-exact, {m.n_bytes} "
              f"bytes in {m.seconds:.4f} s ({m.bytes_per_s / 1e9:.2f} GB/s, "
              f"measured); engine bw_intra now "
              f"{lp.engine.bw_intra / 1e9:.2f} GB/s (model "
              f"{lp.engine.bw_intra_model / 1e9:.2f})")
    del lp, ctx, got
    gc.collect()
    torch.cuda.empty_cache()

    # ---- reduced config: batch-axis SP and a session -----------------------
    rcfg = dataclasses.replace(get_config(SESSION_ARCH).reduced(),
                               n_layers=2, ardit_window_chunks=2)
    g = torch.Generator().manual_seed(0)
    rp = A.open_gates(A.init_params(rcfg, g, "cpu"), g)
    paged = counters["paged_chunk_attention"]
    ref_ex = BatchedChunkExecutor(cfg=rcfg, params=rp, max_streams=2,
                                  device=DEV)
    ref_ex.admit(0, seed=0)
    ref = chunks(ref_ex, 0, 3)
    lp = LanePool(2, cfg=rcfg, params=rp, max_streams=2, devices=pair)
    lp.admit(0, 0, seed=0)
    got = chunks(lp.ex(0), 0, 2)
    if not lp.sp_expand(0, 1) or lp.sp_link(0).mode != "batch":
        raise AssertionError("the pair did not expand in batch mode")
    reset_counts(counters)
    got += chunks(lp.ex(1), 0, 1)               # the guest row, on the CPU
    if paged.launches or lp.ex(0).pool.chunks[0] != 3:
        raise AssertionError("the guest did not run on the CPU lane or its "
                             "KV did not ship home")
    lp.sp_release(0)
    worst = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    print(f"  batch-axis SP across the pair (guest on the CPU lane, its "
          f"chunk KV shipped back to the card): chunks vs the card's SP1 "
          f"run max |d| {worst:.3g} (limit {TOL_CARD_CPU:g})")
    if not worst <= TOL_CARD_CPU:
        raise AssertionError(f"batch-axis SP across the pair: {worst}")

    def serve(devices, force):
        pool = LanePool(len(devices), cfg=rcfg, params=rp, max_streams=3,
                        devices=devices)
        sess = StreamingSession(
            SessionConfig(model_cfg=rcfg, lanes=len(devices), max_batch=1,
                          device=DEV, verbose=False),
            executor=pool, fidelity_policy=StaticFidelity(fid))
        for spec in uniform_specs(2, 3):
            sess.submit(spec)
        if force:
            force_migration_and_sp(sess)
        reset_counts(counters)
        res = sess.run()
        sync()
        out = {sid: [c.cpu() for c in sess.handles[sid].chunks]
               for sid in (0, 1)}
        return res, out, paged.launches

    _, one, _ = serve([DEV], False)
    res, two, launches = serve(pair, True)
    kinds = sorted({m.kind for m in res.engine.measured})
    print(f"  2-device session (card + CPU): applied migrations "
          f"{res.n_migrations_applied}, SP expands "
          f"{res.n_sp_expands_applied}, releases "
          f"{res.n_sp_releases_applied}; measured moves {kinds}; paged "
          f"launches on the card lane {launches}")
    if (res.n_migrations_applied < 1 or res.n_sp_expands_applied < 1
            or res.n_sp_releases_applied < 1
            or kinds != ["migration", "sp-expand"] or launches == 0):
        raise AssertionError("the 2-device session did not migrate, borrow "
                             "across the pair and launch on the card")
    for sid in (0, 1):
        if len(two[sid]) != 3:
            raise AssertionError(f"stream {sid}: {len(two[sid])} chunks")
        for c in range(3):
            err = float((two[sid][c] - one[sid][c]).abs().max())
            worst = max(worst, err)
            print(f"  2-device vs 1-lane session, stream {sid} chunk {c}: "
                  f"max |d| {err:.3g} (limit {TOL_CARD_CPU:g})")
            if not err <= TOL_CARD_CPU:
                raise AssertionError(f"2-device session: {err}")
    return worst


def traced_step(fn):
    """Host wall ms of ``fn()`` (ending in a sync) and the device's busy
    ms in it, from a ``torch.profiler`` trace: the idle share of one
    step is 1 - busy / wall."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(ev.device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, busy


def drive(ex, fid_of, targets, max_batch=8):
    """The reference step-cache tests' ``_drive``: every runnable stream
    begins its next chunk, then one fused step per group."""
    from repro_torch.serve.batcher import compose_batch

    sids = sorted(targets)
    while any(len(ex.chunks[s]) < targets[s] for s in sids):
        runnable = [s for s in sids if len(ex.chunks[s]) < targets[s]]
        for s in runnable:
            if s not in ex.inflight:
                ex.begin_chunk(s, fid_of(s), 0.0)
        for grp in compose_batch(runnable,
                                 lambda s: ex.inflight[s].fidelity,
                                 max_batch, fuse=True):
            ex.run_step(grp)


def smooth_gates(params, scale=None):
    """Phase 5's weights with the adaLN gates opened at ``scale``
    (default SMOOTH_GATES) in place of 0.2, drawn on the card from a
    seeded generator; every other tensor is shared, not copied."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    scale = SMOOTH_GATES if scale is None else scale

    def rnd(t, shift=0.0):
        r = torch.randn(t.shape, generator=gen, device=DEV)
        return (shift + scale * r).to(t.dtype)

    layers = dict(params["layers"], mod=rnd(params["layers"]["mod"]),
                  mod_b=rnd(params["layers"]["mod_b"], 0.5))
    return dict(params, layers=layers, final_mod=rnd(params["final_mod"]))


def phase_stepcache(cfg, params, counters):
    """Phase 13: the step cache at full width (``ardit-self-forcing``,
    bf16, batched paged, phase 5's weights); see the module docstring.
    Returns (iv)'s session and specs for phase 15."""
    from repro_torch.core.bmpr import StaticFidelity
    from repro_torch.core.fidelity import FidelityConfig
    from repro_torch.models import ardit as A
    from repro_torch.models.stepcache import MAX_CONSECUTIVE
    from repro_torch.sched_sim.metrics import summarize
    from repro_torch.serve.batcher import BatchedChunkExecutor
    from repro_torch.serve.session import (SessionConfig, StreamingSession,
                                           uniform_specs)

    paged = counters["paged_chunk_attention"]
    L = cfg.n_layers
    off = FidelityConfig(4, 0.0, cfg.ardit_window_chunks, "bf16")
    agg = off._replace(cache="aggressive")

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()

    # ---- (i) step_cache=True under a static cache="off" fidelity --------
    out = {}
    for step_cache in (True, False):
        fresh()
        sess = StreamingSession(
            SessionConfig(model_cfg=cfg, max_batch=4, step_cache=step_cache,
                          device=DEV, verbose=False),
            executor=BatchedChunkExecutor(cfg=cfg, params=params,
                                          max_streams=3, device=DEV),
            fidelity_policy=StaticFidelity(off))
        hs = [sess.submit(sp) for sp in uniform_specs(2, 2)]
        res = sess.run()
        out[step_cache] = [[c.clone() for c in h.chunks] for h in hs]
        if step_cache and (sess.executor.stepcache is not None
                           or res.step_cache):
            raise AssertionError("a cache=off session built the step cache")
        del sess, hs, res
    for sid in range(2):
        for c in range(2):
            if not torch.equal(out[True][sid][c], out[False][sid][c]):
                raise AssertionError(f"(i) step_cache=True changed stream "
                                     f"{sid} chunk {c} under cache=off")
    print("  (i) step_cache=True under cache=off: no manager built, chunks "
          "bit-identical to step_cache=False")

    def executor(n, weights):
        fresh()
        ex = BatchedChunkExecutor(cfg=cfg, params=weights,
                                  max_streams=n + 1, device=DEV)
        for sid in range(n):
            if not ex.admit(sid, seed=sid):
                raise AssertionError("admission failed")
        return ex

    def watch_decisions(ex):
        """Record (delta, threshold, hit) at each eligible hit decision
        of ``ex``'s step cache, checking hit == (delta < threshold)."""
        seen = []
        decide = ex._stepcache().should_hit

        def spy(sid, level):
            st = ex.stepcache.states.get(sid)
            eligible = (st is not None and st.delta is not None
                        and st.n_computed >= 2
                        and st.consecutive < MAX_CONSECUTIVE[level])
            d = float(st.delta) if eligible else None
            hit = decide(sid, level)
            if eligible:
                thr = ex.stepcache.effective_threshold(level, st.motion)
                seen.append((round(d, 4), round(thr, 4), hit))
                if hit != (d < thr):
                    raise AssertionError("a hit decision off its threshold")
            return hit

        ex.stepcache.should_hit = spy
        return seen

    # ---- the gate, both ways ---------------------------------------------
    # phase 5's weights open the adaLN gates at 0.2; the rest of the
    # phase runs on the same weights with the gates opened at
    # SMOOTH_GATES, whose velocity field changes less between steps
    ex = executor(1, params)
    seen = watch_decisions(ex)
    drive(ex, lambda s: agg, {0: 2})
    print(f"  phase 5's weights (gates 0.2) on aggressive, 1 stream x 2 "
          f"chunks: (delta, threshold, hit) at each eligible decision "
          f"{seen}; {ex.stepcache.stats()}")
    del ex
    params = smooth_gates(params)

    # ---- (ii) 2 streams x 3 chunks, stream 1 on aggressive ---------------

    ref = executor(2, params)
    drive(ref, lambda s: off, {0: 3, 1: 3})
    ref_chunks = [[c.clone() for c in ref.chunks[s]] for s in (0, 1)]
    ref_dispatch = ref.dispatch_count
    del ref
    mix = executor(2, params)
    drive(mix, lambda s: agg if s == 1 else off, {0: 3, 1: 3})
    sc = mix.stepcache
    print(f"  (ii) stream 1 aggressive beside stream 0 off: {sc.stats()}, "
          f"dispatches {mix.dispatch_count} (all off: {ref_dispatch}), "
          f"skipped launches {mix.cache_skipped_launches}")
    if sc is None or sc.hits == 0:
        raise AssertionError("(ii) the aggressive stream never hit")
    for c in range(3):
        if not torch.equal(mix.chunks[0][c], ref_chunks[0][c]):
            raise AssertionError(f"(ii) the off stream's chunk {c} changed "
                                 f"beside a cache row")
    drift2 = max(float((a - b).abs().max())
                 for a, b in zip(mix.chunks[1], ref_chunks[1]))
    print(f"  (ii) stream 0's chunks bit-identical to the all-off run; "
          f"stream 1's drift against off {drift2:.4g}")
    del mix, ref_chunks

    # ---- (iii) 1 stream x 3 chunks, aggressive against off ---------------
    # the first chunk step by step under the profiler (its hits come
    # before any motion history scales the threshold down), then two more
    def first_chunk_traced(ex, fid):
        ex.begin_chunk(0, fid, 0.0)
        rows = []
        while ex.inflight:
            skipped = ex.cache_skipped_launches
            hits_before = ex.stepcache.hits if ex.stepcache else 0
            wall, busy = traced_step(lambda: ex.run_step([0]))
            kind = ("hit, launch skipped"
                    if ex.cache_skipped_launches > skipped else
                    "hit row" if ex.stepcache and ex.stepcache.hits
                    > hits_before else "computed")
            rows.append(f"{kind}: {wall:.1f} ms wall, {busy:.1f} ms busy, "
                        f"idle {100 * (1 - busy / wall):.1f}%")
        print(f"  (iii) first chunk, cache {fid.cache}, traced step by step "
              f"(1 row, no context):")
        for r in rows:
            print(f"      {r}")

    one_off = executor(1, params)
    reset_counts(counters)
    first_chunk_traced(one_off, off)
    drive(one_off, lambda s: off, {0: 3})
    off_launches = paged.launches
    agg_ex = executor(1, params)
    hits = []

    def spy_apply(sid, x, dt):
        st = agg_ex.stepcache.states[sid]
        v = agg_ex.stepcache.pool.v[st.slot].clone()
        got = real_apply(sid, x, dt)
        hits.append((x.clone(), v, dt, got))
        return got

    real_apply = agg_ex._stepcache().apply_hit
    agg_ex.stepcache.apply_hit = spy_apply
    seen = watch_decisions(agg_ex)
    reset_counts(counters)
    first_chunk_traced(agg_ex, agg)
    drive(agg_ex, lambda s: agg, {0: 3})
    sync()
    launches, launches_tc = paged.launches, paged.launches_tc
    sc = agg_ex.stepcache
    print(f"  (iii) one stream aggressive: {sc.stats()}, dispatches "
          f"{agg_ex.dispatch_count} (off: {one_off.dispatch_count}), "
          f"skipped launches {agg_ex.cache_skipped_launches}, paged launches "
          f"{launches} (off: {off_launches}), on the tensor cores "
          f"{launches_tc}")
    if agg_ex.cache_skipped_launches == 0 or \
            agg_ex.dispatch_count >= one_off.dispatch_count:
        raise AssertionError("(iii) no launch was skipped")
    if launches != L * agg_ex.dispatch_count or launches_tc != launches:
        raise AssertionError(f"(iii) {launches} paged launches "
                             f"({launches_tc} on the tensor cores) for "
                             f"{agg_ex.dispatch_count} dispatches")
    for x, v, dt, got in hits:
        # one rounding of x - dt v (the product of two fp32 values is
        # exact in fp64), as the multiply-add computes it
        want = (x.double() - float(np.float32(dt)) * v.double()).float()
        if got.dtype != torch.float32 or not torch.equal(got, want):
            raise AssertionError("(iii) a hit's output is not x - dt v")
    drift = max(float((a - b).abs().max())
                for a, b in zip(agg_ex.chunks[0], one_off.chunks[0]))
    print(f"  (iii) {len(hits)} hits, each x - dt v bit for bit; drift of "
          f"the chunks against off: max |a - b| {drift:.4g} (not gated); "
          f"(delta, threshold, hit) at each eligible decision {seen}")
    del one_off, agg_ex, hits

    # ---- (iv) the default BMPR policy with the cache levels unlocked ----
    session = specs = None
    for factor in FACTORS_IV:
        fresh()
        session = StreamingSession(SessionConfig(
            model_cfg=cfg, max_batch=4, step_cache=True,
            budget_factor=factor, device=DEV, verbose=False),
            executor=BatchedChunkExecutor(cfg=cfg, params=params,
                                          max_streams=4, device=DEV))
        specs = uniform_specs(3, 3)
        for sp in specs:
            session.submit(sp)
        t0 = time.perf_counter()
        res = session.run()
        sync()
        wall = time.perf_counter() - t0
        mix = dict(sorted(session.fidelity_counts.items()))
        print(f"  (iv) BMPR with the step cache, budget factor {factor}: "
              f"{summarize(res).row()}; wall {wall:.2f} s")
        print(f"      fidelity mix {mix}")
        print(f"      step_cache {res.step_cache}")
        for key, lat in sorted(session.executor.latency_ema.items()):
            print(f"      chunk latency EMA {key}: {lat:.3f} s")
        if any(k.endswith(("_ca", "_cc")) for k in mix):
            break
    else:
        raise AssertionError(f"(iv) BMPR picked no cache level at budget "
                             f"factors {FACTORS_IV}")
    for h in session.handles.values():
        if not h.done or not all(bool(torch.isfinite(c).all())
                                 and tuple(c.shape) == (
                                     1, A.chunk_tokens(cfg), A.LATENT_CH)
                                 for c in h.chunks):
            raise AssertionError(f"(iv) stream {h.sid}: bad chunks")
    return session, specs


def phase_modelplane(cfg, params, counters):
    """Phase 14: co-served ``ardit-self-forcing`` (phase 5's weights) and
    ``ardit-causal-forcing`` (fresh, gates opened) at full width; see the
    module docstring.  Returns the co-serve session for phase 15."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.bmpr import StaticFidelity
    from repro_torch.core.fidelity import FidelityConfig
    from repro_torch.models import ardit as A
    from repro_torch.sched_sim.metrics import summarize
    from repro_torch.serve import session as S
    from repro_torch.serve.batcher import BatchedChunkExecutor
    from repro_torch.serve.modelplane import resolve_bundle

    paged = counters["paged_chunk_attention"]
    fid = FidelityConfig(2, 0.0, 7, "bf16")
    cf_cfg = get_config(CO_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(1)
    cf_params = A.open_gates(A.init_params(cf_cfg, gen, DEV), gen)
    print(f"  {CO_ARCH}: {cf_cfg.n_heads} heads of {cf_cfg.head_dim}, "
          f"init {time.perf_counter() - t0:.1f} s")
    b_sf = resolve_bundle(cfg, params=params, device=DEV)
    b_cf = resolve_bundle(cf_cfg, params=cf_params, device=DEV)
    names = [b_sf.name, b_cf.name]
    specs = [dataclasses.replace(sp, model=names[i % 2])
             for i, sp in enumerate(S.uniform_specs(4, 2))]

    def serve(bundles, specs, executor=None, model_cfg=None, spy=None):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        paged.launches_by_dim.clear()
        t0 = time.perf_counter()
        sess = S.StreamingSession(
            S.SessionConfig(models=bundles, model_cfg=model_cfg,
                            pool_streams=2, max_batch=4, device=DEV,
                            verbose=False),
            executor=executor, fidelity_policy=StaticFidelity(fid))
        for sp in specs:
            sess.submit(sp)
        res = sess.run()
        sync()
        return sess, res, time.perf_counter() - t0

    groups = []
    compose = S.compose_batch

    def spy(*a, **kw):
        got = compose(*a, **kw)
        groups.extend(got)
        return got

    S.compose_batch = spy
    try:
        co, co_res, wall = serve([b_sf, b_cf], specs)
    finally:
        S.compose_batch = compose
    summ = summarize(co_res)
    by_dim = dict(paged.launches_by_dim)
    disp = {b.name: sum(ex.dispatch_count
                        for ex in co.lanes.bundle_executors[b.name])
            for b in co.bundles}
    print(f"  co-serve session: {summ.row()}; wall {wall:.2f} s (two "
          f"warm-up chunks included), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for line in summ.model_rows():
        print(f"  {line.strip()}")
    print(f"  dispatches {disp}; paged launches {paged.launches} (tensor "
          f"cores {paged.launches_tc}) by head dim {by_dim}; sub-batches "
          f"{len(groups)}")
    if summ.n_unserved or set(summ.by_model) != set(names):
        raise AssertionError(f"co-serve: unserved {summ.n_unserved}, rows "
                             f"{sorted(summ.by_model)}")
    if not groups or any(len({co.lanes.model_of[s] for s in g}) != 1
                         for g in groups):
        raise AssertionError("a sub-batch mixed models")
    if by_dim != {cfg.head_dim: cfg.n_layers * disp[b_sf.name],
                  cf_cfg.head_dim: cf_cfg.n_layers * disp[b_cf.name]} \
            or paged.launches_tc != paged.launches:
        raise AssertionError("co-serve: paged launches are not n_layers x "
                             "dispatches per model on the tensor cores")
    for b in co.bundles:
        print(f"  {b.name}: warm-up chunk {b.top_latency:.3f} s, "
              f"time scale {b.time_scale:.3f}, page {b.page_bytes / 1e6:.1f}"
              f" MB, chunk latency EMA "
              f"{co.lanes.ex_for(0, b.name).latency_ema[fid.key]:.3f} s")
    co_chunks = {h.sid: [c.clone() for c in h.chunks]
                 for h in co.handles.values()}
    worst = 0.0
    for b in (b_sf, b_cf):
        solo_specs = [sp for sp in specs if sp.model == b.name]
        solo, _, solo_wall = serve([b], solo_specs)
        for sp in solo_specs:
            for c, got in enumerate(solo.handles[sp.sid].chunks):
                worst = max(worst, same_or_ulp(
                    f"co-serve vs solo {b.name}, stream {sp.sid} chunk {c}",
                    co_chunks[sp.sid][c], got))
        print(f"  solo {b.name}: wall {solo_wall:.2f} s")
        del solo
    # a single bundle is the model_cfg path
    one = [dataclasses.replace(sp, model=None)
           for sp in S.uniform_specs(2, 2)]
    single, _, _ = serve([b_cf], one)
    a = {h.sid: [c.clone() for c in h.chunks]
         for h in single.handles.values()}
    del single
    legacy, _, _ = serve(None, one, executor=BatchedChunkExecutor(
        cfg=cf_cfg, params=cf_params, max_streams=2, device=DEV),
        model_cfg=None)
    for sid, cs in a.items():
        for c, got in enumerate(cs):
            if not torch.equal(got, legacy.handles[sid].chunks[c]):
                raise AssertionError(f"single bundle vs model_cfg: stream "
                                     f"{sid} chunk {c} differs")
    print(f"  single-bundle {b_cf.name} session == model_cfg session, bit "
          f"for bit ({sum(len(c) for c in a.values())} chunks)")
    del legacy, cf_params, b_cf
    return co, worst


def phase_calibration(sc_session, sc_specs, co_session):
    """Phase 15: the simulator calibrated from the card's sessions."""
    from repro_torch.sched_sim.calibration import agreement, fit_session
    from repro_torch.sched_sim.metrics import summarize
    from repro_torch.sched_sim.policies import make_policy
    from repro_torch.sched_sim.simulator import Simulator

    real = summarize(sc_session.result())
    report = fit_session(sc_session)
    sim = summarize(Simulator(
        report.sim_config(n_workers=1, workers_per_node=1), sc_specs,
        make_policy("slackserve", model=report.model,
                    profile=report.profile())).run())
    print(f"  phase 13 (iv) fit: model {report.model}, scale "
          f"{report.scale:.4g}, chunk_seconds {report.chunk_seconds:.4g}, "
          f"ratios { {k: round(v, 4) for k, v in report.ratios.items()} }, "
          f"cache_speedups "
          f"{ {k: round(v, 4) for k, v in report.cache_speedups.items()} }")
    print(f"  replay: real {real.row()}")
    print(f"          sim  {sim.row()}")
    print(f"  agreement {agreement(real, sim)}")
    for name in (b.name for b in co_session.bundles):
        rep = fit_session(co_session, model=name)
        print(f"  phase 14 fit, {name}: model {rep.model}, scale "
              f"{rep.scale:.4g}, ratios "
              f"{ {k: round(v, 4) for k, v in rep.ratios.items()} }")


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
               flash_ops.BWD_SOURCE, flash_ops.BWD_TC_SOURCE, ssd_ops.SOURCE,
               fp8_ops.SOURCE]
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
            for name, regs_, spill in part:
                if spill or src == flash_ops.BWD_TC_SOURCE:
                    print(f"    {name}: {regs_} registers, {spill} bytes of "
                          f"spills")
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
    flash_bwd = {"name": "flash_mha_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/flash_attention/csrc/"
                           "flash_mha_bwd.cu",
                 "replaces": "src/repro/kernels/flash_attention/kernel.py:132",
                 "path": "cuda_cores"}
    flash_bwd_tc = {"name": "flash_mha_bwd_wgmma", "route": "cuda",
                    "source": "src/repro_torch/kernels/flash_attention/csrc/"
                              "flash_mha_bwd_wgmma.cu",
                    "replaces": "src/repro/kernels/flash_attention/"
                                "kernel.py:132",
                    "path": "wgmma"}
    fp8 = {"name": "fp8_matmul", "route": "cuda",
           "source": "src/repro_torch/kernels/fp8_matmul/csrc/fp8_matmul.cu",
           "replaces": "src/repro/kernels/fp8_matmul/kernel.py:42",
           "path": "wgmma"}
    counters = {"paged_chunk_attention": paged_ops.paged_chunk_attention,
                "flash_mha": flash_ops.flash_mha,
                "paged_decode_attention": paged_ops.paged_decode_attention,
                "fp8_matmul": fp8_ops.fp8_scaled_matmul}
    seconds = {}

    def phase(title, fn, *args):
        """Run one phase under its heading and print its seconds."""
        print(f"== phase {title}")
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[title.split(":")[0]] = time.perf_counter() - t0
        print(f"  (phase {title.split(':')[0]}: "
              f"{seconds[title.split(':')[0]]:.1f} s)")
        return out

    phase("2: paged kernel vs plain version at full-width shapes",
          phase_kernel, paged)
    phase("3: flash kernel vs plain version", phase_flash, flash)
    phase("4: reduced config, card vs CPU", phase_integration)
    cfg, params = full_width_params()
    paged["launches"] = phase(
        "5: full-width ardit-self-forcing, batched paged session",
        phase_batched, cfg, params, counters)
    seq_launches = phase(
        "6: full-width ardit-self-forcing, sequential session",
        phase_sequential, cfg, params, counters)
    phase("7: full-width ardit-self-forcing, gather-backend session",
          phase_gather, cfg, params, counters)
    phase("10: full-width elastic SP and migration, two lanes on the card",
          phase_lanes, cfg, params, counters)
    phase("10 (iii): lanes on different devices, card + CPU",
          phase_device_pair, cfg, params, counters)
    sc_session, sc_specs = phase("13: full-width step cache",
                                 phase_stepcache, cfg, params, counters)
    co_session, _ = phase(
        f"14: full-width co-serving, {SESSION_ARCH} + {CO_ARCH}",
        phase_modelplane, cfg, params, counters)
    phase("15: the simulator calibrated from the card's sessions",
          phase_calibration, sc_session, sc_specs, co_session)
    del sc_session, co_session
    phase("17: full-width ring batched cache vs the paged executor",
          phase_ring, cfg, params, counters)
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    phase("8: SSD kernel vs plain version", phase_ssd, ssd)
    ssd["launches"] = phase(f"9: full-width {SSM_ARCH} prefill and decode",
                            phase_ssm, {**counters, "ssd": ssd_ops.ssd})
    phase(f"11: paged decode kernel vs plain version ({DECODE_ARCH} "
          f"decode_32k)", phase_decode, decode, counters)
    phase("12: fp8 matmul kernel vs plain version", phase_fp8, fp8,
          counters)
    gc.collect()
    torch.cuda.empty_cache()
    fam = phase("16: full-width token families (dense, MoE, VLM, hybrid, "
                "encoder-decoder) prefill and decode", phase_families,
                {**counters, "ssd": ssd_ops.ssd})
    gc.collect()
    torch.cuda.empty_cache()
    phase("18: flash kernel backward vs plain version", phase_flash_bwd,
          flash_bwd, flash_bwd_tc)
    train, parity_bwd = phase(
        "19: training (reduced configs card vs CPU, full-width minicpm-2b "
        "and ardit-self-forcing, a checkpoint)", phase_train)
    gc.collect()
    torch.cuda.empty_cache()
    sharded = phase("20: sharded steps on a 1x1 mesh (minicpm-2b training, "
                    f"{SSM_ARCH} serving, restore, compressed all-reduce)",
                    phase_sharded, train)
    examples_fwd, examples_bwd = phase(
        "21: the examples on the card (quickstart, train_small)",
        phase_examples, counters)
    train_fwd = sum(r["launches"] for r in train.values())
    # kernel 3's backward on its paths: the CUDA cores in phase 19 (i)'s
    # and phase 21's reduced fp32 training, the tensor cores in 19 (ii)'s
    # full-width bf16
    flash_bwd["launches"] = parity_bwd + examples_bwd
    flash_bwd_tc["launches"] = sum(r["launches_bwd_tc"]
                                   for r in train.values()) \
        + sharded["flash_mha_bwd_tc"]
    # kernel 4: phase 9 (bf16 on the tensor cores, fp32 on the CUDA
    # cores), phase 16's bf16 Jamba prefills ((64, 16), tensor cores) and
    # phase 20 (ii)
    ssd["launches"] += fam["ssd"] + sharded["ssd"]
    if not (flash_bwd["launches"] and flash_bwd_tc["launches"]):
        raise AssertionError("a backward kernel was not launched on its "
                             "training path")
    # kernel 3 on its paths: the sequential session, then phase 16's bf16
    # prefills and whisper-medium's bf16 decode steps, then phase 19's
    # full-width training, phase 20's sharded training and phase 21's
    # examples
    flash["launches"] = seq_launches + fam["flash_mha"] \
        + fam["flash_mha_decode"] + train_fwd + sharded["flash_mha"] \
        + examples_fwd
    print(f"flash_mha launches: {seq_launches} (phase 6) + "
          f"{fam['flash_mha']} (phase 16 prefills) + "
          f"{fam['flash_mha_decode']} (phase 16 decode steps) + "
          f"{train_fwd} (phase 19 (ii) training) + {sharded['flash_mha']} "
          f"(phase 20 (i) sharded training) + {examples_fwd} (phase 21, "
          f"CUDA cores) = {flash['launches']}; flash_mha_bwd launches on "
          f"the CUDA cores: {parity_bwd} (phase 19 (i)) + {examples_bwd} "
          f"(phase 21) = {flash_bwd['launches']}, on the tensor cores "
          f"(phases 19 (ii) and 20 (i)): {flash_bwd_tc['launches']}; "
          f"ssd_scan launches (phases 9, 16 and 20 (ii)): "
          f"{ssd['launches']}")
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in seconds.items()))

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s, build included")
    keys = ("name", "route", "source", "replaces", "path", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in (paged, decode, flash, flash_bwd,
                                            flash_bwd_tc, ssd, fp8)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
