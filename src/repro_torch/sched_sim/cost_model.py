"""Modeled hardware constants for the cluster simulator.

Everything the simulator cannot measure on this CPU container is derived
here, with the derivation recorded (DESIGN.md SS8).  Swapping in measured
values is a one-file change.

Testbed (paper SS7.1): 2 nodes x 8 H100-80GB, NVLink 900 GB/s/GPU
intra-node, 400 Gb/s InfiniBand across nodes.

KV page accounting (Self-Forcing-class AR-DiT, 480p):
    tokens/latent-frame = 880; 12 KV heads x 128 head dim; 30 layers
    page = 1 latent frame across all layers (frame-granularity paging,
    SS4.4 footnote: frame-level paging avoids fragmentation)
    page bytes = 880 * 12 * 128 * 2(K,V) * 2(bf16) * 30 = 162.3 MB
    full stream (cond sink + 7-chunk window = 21 frames + sink) ~ 3.5 GB
    pool per worker = kappa * 80 GB = 64 GB ~ 394 pages (~18 streams)

Transfer model (paper App. D.2 reports 31.8 ms avg / 118.4 ms P95 per
KV transfer, 4.4 ms avg residual wait under layer-wise streaming):
    effective intra-node P2P   200 GB/s  (NVLink practical share)
    effective cross-node RDMA   40 GB/s  (400 Gb/s IB, ~80% efficiency)
    fixed submission overhead    4 ms    (page lookup, CUDA events)
A ~2 GB average resident state then costs ~14 ms intra / ~54 ms cross —
the observed 31.8 ms average falls between, and first-layer readiness
(1/30 of the bytes) lands at ~4-6 ms, matching the residual-wait table.

SDV2 batching (SS7.1): batched diffusion steps amortize weight reads;
we model batch-of-b per-step latency as t_step * (0.4 + 0.6 b)
(throughput rises ~1.7x at b=4 while per-chunk latency rises ~2.8x),
consistent with SS7.2's observation that SDV2 "increases per-chunk
latency" while raising aggregate FPS.
"""
from __future__ import annotations

# --- cluster topology (paper testbed) ---------------------------------------
N_WORKERS = 16
WORKERS_PER_NODE = 8

# --- playout (SS7.1) ---------------------------------------------------------
FPS = 16
PIXEL_FRAMES_PER_CHUNK = 12          # 3 latent frames x 4 VAE temporal rate
CHUNK_SECONDS = PIXEL_FRAMES_PER_CHUNK / FPS      # 0.75 s
STREAM_FRAMES = (81, 129, 161, 241)  # ~5-15 s at 16 fps (App. B)

# --- KV paging ---------------------------------------------------------------
PAGE_BYTES = 880 * 12 * 128 * 2 * 2 * 30         # 162.3 MB / latent frame
FRAMES_PER_CHUNK = 3
SINK_PAGES = 1                        # cond tokens ~ one page equivalent
MAX_WINDOW_CHUNKS = 7
POOL_BYTES = int(0.8 * 80e9)          # kappa = 0.8 of 80 GB VRAM (SS4.4)
POOL_PAGES = POOL_BYTES // PAGE_BYTES

# --- transfer engine ----------------------------------------------------------
BW_INTRA = 200e9
BW_INTER = 40e9
TRANSFER_OVERHEAD_S = 0.004
N_LAYERS = 30

# --- baseline modeling --------------------------------------------------------
SDV2_BATCH = 4


SDV2_BATCH_ALPHA = 0.9   # default marginal per-stream step-cost slope


def sdv2_batch_step_factor(b: int, alpha: float = SDV2_BATCH_ALPHA) -> float:
    """Per-step latency multiplier for a lockstep batch of ``b``.

    A 1.3B AR-DiT at 480p is compute-bound at batch 1 (2640-token chunks
    saturate the GPU), so batching amortizes little: ~10% per added
    stream (``alpha = 0.9`` marginal cost).  Throughput gain at b=4 is
    b/factor = 1.08x while every member's chunk latency inflates 3.4x —
    which is exactly SS7.2's observation that SDV2 raises aggregate FPS
    but not per-stream timeliness, leaving multi-stream workers URGENT
    (Fig. 15).  ``alpha`` is a calibration target: the sim-vs-real
    fitting loop (``sched_sim.calibration``) re-estimates it from the
    real batched executor's per-batch-size step EMAs."""
    return 1.0 + alpha * (b - 1)


# --- step cache (AdaCache-style residual reuse, models/stepcache.py) ---------
# The expected-hit-rate latency model lives with the other latency
# surfaces in the profiler; re-exported here so the simulator's cost
# constants stay one import away.
from repro_torch.profiler.profiles import (  # noqa: E402,F401
    STEP_CACHE_HIT_RATE, step_cache_latency_factor,
)


# --- per-model KV footprint (heterogeneous co-serving) -----------------------
# Bytes-per-page multiplier vs the Wan-1.3B AR-DiT reference (12 KV heads
# x 128 head dim x 30 layers).  The paper's two AR-DiT columns share that
# KV geometry (causal-forcing: 16 heads x 96 = same bytes/row).  Other
# registry families carry analytic priors: an SSM holds O(1) state
# instead of a KV window, MoE/dense KV scales with layers x kv_heads x
# head_dim.  Consumed by the simulator's residency/transfer model only.
MODEL_PAGE_FACTOR = {
    "causal-forcing": 1.0,
    "self-forcing": 1.0,
    "mamba2-780m": 0.02,
    "minicpm-2b": 0.5,
    "granite-moe-1b-a400m": 0.4,
    "minitron-8b": 0.8,
    "internlm2-20b": 1.5,
    "jamba-v0.1-52b": 0.3,
    "internvl2-26b": 1.6,
    "qwen1.5-32b": 2.0,
    "qwen3-moe-235b-a22b": 3.0,
    "whisper-medium": 0.6,
}


def model_page_factor(model) -> float:
    return MODEL_PAGE_FACTOR.get(model, 1.0) if model is not None else 1.0


def stream_pages(chunks_resident: int, model=None) -> int:
    """Pages held by a stream with ``chunks_resident`` chunks in window.

    ``model`` scales the count by the bundle's page-footprint factor
    (rounded up: a fractional page still occupies a page); None is the
    exact legacy count."""
    pages = SINK_PAGES + min(chunks_resident,
                             MAX_WINDOW_CHUNKS) * FRAMES_PER_CHUNK
    factor = model_page_factor(model)
    if factor != 1.0:
        import math
        pages = max(1, math.ceil(pages * factor))
    return pages


def stream_bytes(chunks_resident: int, model=None) -> int:
    return stream_pages(chunks_resident, model) * PAGE_BYTES


TS_RECONFIG_S = 0.30     # TridentServe SP/parallelism reconfiguration stall
                         # (SS7.2: "parallelism reconfiguration also delays
                         #  the first chunk, inflating TTFC")
