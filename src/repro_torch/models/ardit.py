"""AR-DiT: chunk-wise autoregressive video diffusion transformer
(serving surface of the JAX reference's ``models/ardit.py``).

Video is generated one *chunk* (``chunk_frames`` latent frames =
``chunk_tokens`` tokens) at a time; each chunk is denoised over ``S``
steps with bidirectional in-chunk attention, and every token also
attends to the rolling KV cache of earlier chunks (sink + local window,
SS2.1).  The conditioning embeddings occupy the sink.  All four
fidelity knobs are live (S steps, rho sparsity, W window, Q fp8 KV).

Three forwards share one DiT body (``_dit_forward``) and differ in how
attention sees the cached context:

* ``chunk_forward`` / ``denoise_step`` / ``serve_chunk`` — a contiguous
  context [L, B, ctx, Hkv, Dh] (the sequential cache, or the batched
  executor's ``gather`` backend) concatenated with the chunk's own KV
  through ``attention.mha`` (the flash-attention kernel on the card);
* ``chunk_forward_paged`` / ``denoise_step_paged`` — the context read in
  place from the paged KV pool through ``attention.paged_mha``;
* ``chunk_forward_paged_sp`` / ``denoise_step_paged_sp`` — elastic SP2:
  the same, with the KV heads split between a home and a donor pool,
  each half read through a head-range view of its pool.

The ring batched cache (``init_batched_cache``, ``chunk_step``,
``append_chunk_kv_batched``, ``serve_chunk_batched``) keeps a batch of
streams in one fixed-capacity [L, B, cap, Hkv, Dh] ring and reads it
through per-row visibility masks: ``mha``'s plain masked segment on
every device, as the reference runs that segment in jnp on the TPU too.

The stacked ``[L, ...]`` layer parameters are consumed by a Python loop
(the reference's ``lax.scan``).  ``train_loss`` is the reference's
flow-matching loss over a chunk sequence (no remat, as there); on the
card its attention is the flash kernel with its backward.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models import layers as L
from repro_torch.models.attention import (mha, merge_head_shards, paged_mha,
                                         shard_heads, sparse_keep_list)
from repro_torch.models.layers import DTYPES

Params = Dict[str, Any]

LATENT_CH = 16          # latent channels out of the (stubbed) video VAE
COND_TOKENS = 77        # text-conditioning tokens (stub encoder output)


class FidelityConfig(NamedTuple):
    """A concrete assignment of the paper's four fidelity knobs (SS5),
    plus the repo's fifth knob: the AdaCache-style step cache (its
    executor side waits for the step-cache slice)."""
    steps: int = 4              # S in {2,3,4}
    sparsity: float = 0.0       # rho in {0,.6,.7,.8,.9}
    window: int = 7             # W in {1,3,7} chunks
    quant: str = "bf16"         # Q in {bf16,fp8}
    cache: str = "off"          # step cache in {off,conservative,aggressive}

    @property
    def key(self) -> str:
        # cache=off keys are unchanged from the 4-knob era so existing
        # EMAs, calibration ratios, and parity baselines stay valid
        base = f"S{self.steps}_r{self.sparsity}_W{self.window}_{self.quant}"
        return base if self.cache == "off" else f"{base}_c{self.cache[0]}"


HIGHEST_QUALITY = FidelityConfig(4, 0.0, 7, "bf16")


def chunk_tokens(cfg: ModelConfig) -> int:
    return cfg.ardit_chunk_frames * cfg.ardit_frame_tokens


def cache_capacity(cfg: ModelConfig) -> int:
    """KV capacity in tokens: cond sink + window chunks."""
    return COND_TOKENS + cfg.ardit_window_chunks * chunk_tokens(cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(cfg: ModelConfig, gen: torch.Generator, dtype,
                device="cpu") -> Params:
    d = cfg.d_model
    return {
        "attn": L.init_attn(cfg, gen, dtype, device),
        "mlp": L.init_mlp(cfg, gen, dtype, device),
        # adaLN-zero: 6 modulation vectors per layer
        "mod": torch.zeros((d, 6 * d), dtype=dtype, device=device),
        "mod_b": torch.zeros((6 * d,), dtype=dtype, device=device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Fresh parameters: the reference's shapes and scales
    (``layers.dense_init``), adaLN gates zero.  Values are drawn from
    ``generator`` on its own device — so they do not depend on the
    target device — one layer at a time into the stacked ``[L, ...]``
    layout.  On ``"meta"`` nothing is drawn (``generator`` may be
    None)."""
    dtype = DTYPES[cfg.param_dtype]
    d = cfg.d_model

    def dense(shape, **kw):
        return L.dense_init(generator, shape, dtype, device=device, **kw)

    return {
        "in_proj": dense((LATENT_CH, d)),
        "cond_proj": dense((d, d)),
        "t_mlp1": dense((256, d)),
        "t_mlp2": dense((d, d)),
        "layers": L.init_stacked(
            cfg.n_layers,
            lambda: _init_layer(cfg, generator, dtype, device)),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "final_mod": torch.zeros((d, 2 * d), dtype=dtype, device=device),
        "out_proj": dense((d, LATENT_CH), scale=0.02),
    }


def open_gates(p: Params, generator: torch.Generator) -> Params:
    """Open the adaLN-zero gates with small random modulation weights
    (``mod`` ~ 0.2 N, ``mod_b`` ~ 0.5 + 0.2 N, ``final_mod`` ~ 0.2 N,
    drawn on the CPU).  With fresh params every residual branch is
    multiplied by 0 and the output ignores the KV context; smoke runs
    with random weights open them so attention really matters."""
    def rnd(t, scale, shift=0.0):
        r = torch.randn(t.shape, generator=generator, dtype=torch.float32)
        return (shift + scale * r).to(t.dtype).to(t.device)

    p["layers"]["mod"] = rnd(p["layers"]["mod"], 0.2)
    p["layers"]["mod_b"] = rnd(p["layers"]["mod_b"], 0.2, 0.5)
    p["final_mod"] = rnd(p["final_mod"], 0.2)
    return p


def _time_embed(p: Params, t: torch.Tensor, d: int) -> torch.Tensor:
    """t [B] in [0,1] -> [B, D] conditioning vector."""
    half = 128
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :] * 1000.0
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)   # [B,256]
    h = F.silu(emb.to(p["t_mlp1"].dtype) @ p["t_mlp1"])
    return h @ p["t_mlp2"]


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def cache_sparse_index(cfg: ModelConfig, ctx_len: int,
                       sparsity: float) -> Optional[np.ndarray]:
    """Static token indices of the cached context kept under knob rho.

    Sink (cond) tokens and the most recent chunk are always kept; a strided
    ~(1-rho) fraction of the middle blocks survives (SS5, Light-Forcing
    style block sparsity, 128-aligned).
    """
    if sparsity <= 0.0 or ctx_len <= COND_TOKENS:
        return None
    blk = 128
    body = ctx_len - COND_TOKENS
    n_blocks = max(1, body // blk)
    keep = sparse_keep_list(1, [n_blocks], sparsity, sink_blocks=1)[0]
    idx = [np.arange(COND_TOKENS)]
    for j in keep:
        lo = COND_TOKENS + j * blk
        hi = min(COND_TOKENS + (j + 1) * blk, ctx_len)
        idx.append(np.arange(lo, hi))
    tail = COND_TOKENS + n_blocks * blk
    if tail < ctx_len:
        idx.append(np.arange(tail, ctx_len))
    return np.unique(np.concatenate(idx))


def sigma_schedule(steps: int) -> np.ndarray:
    """Rectified-flow time grid 1 -> 0 (noise -> data)."""
    return np.linspace(1.0, 0.0, steps + 1)


# ---------------------------------------------------------------------------
# the DiT body and the contiguous-context forward
# ---------------------------------------------------------------------------

def _dit_forward(cfg: ModelConfig, p: Params, x_chunk: torch.Tensor,
                 t: torch.Tensor, q_offset,
                 attend: Callable[[int, torch.Tensor, torch.Tensor,
                                   torch.Tensor], torch.Tensor],
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """DiT body shared by the forwards: ``attend(layer, q, k, v)`` gives
    layer ``layer``'s attention output [B, T_c, Hq, Dh] for the chunk's
    own q/k/v and whatever context the caller holds.  ``q_offset`` is an
    int or a per-stream [B] tensor."""
    b, tc, _ = x_chunk.shape
    d = cfg.d_model
    h = x_chunk.to(p["in_proj"].dtype) @ p["in_proj"]
    temb = _time_embed(p, t, d)                                   # [B,D]
    q_off = torch.as_tensor(q_offset, device=h.device)
    ar = torch.arange(tc, device=h.device)
    positions = (q_off[:, None] + ar[None, :] if q_off.ndim
                 else q_off + ar)                                 # [B,Tc]|[Tc]
    ones = torch.ones((d,), dtype=h.dtype, device=h.device)
    silu_t = F.silu(temb)

    ks, vs = [], []
    for li, lp in enumerate(L.unstack(p["layers"], cfg.n_layers)):
        mod = silu_t @ lp["mod"] + lp["mod_b"]                    # [B,6D]
        sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(mod, 6, dim=-1)
        a_in = _modulate(L.rmsnorm(h, ones, cfg.norm_eps), sh1, sc1)
        q, k, v = L.attn_qkv(cfg, lp["attn"], a_in, positions)
        o = attend(li, q, k, v).reshape(b, tc, cfg.n_heads * cfg.head_dim)
        h = h + g1[:, None, :] * (o @ lp["attn"]["wo"])
        f_in = _modulate(L.rmsnorm(h, ones, cfg.norm_eps), sh2, sc2)
        h = h + g2[:, None, :] * L.mlp_block(cfg, lp["mlp"], f_in)
        ks.append(k)
        vs.append(v)

    mod = silu_t @ p["final_mod"]
    sh, sc = torch.chunk(mod, 2, dim=-1)
    h = _modulate(L.rmsnorm(h, p["final_norm"], cfg.norm_eps), sh, sc)
    return h @ p["out_proj"], {"k": torch.stack(ks), "v": torch.stack(vs)}


def chunk_forward(cfg: ModelConfig, p: Params, x_chunk: torch.Tensor,
                  t: torch.Tensor, ctx_k: Optional[torch.Tensor],
                  ctx_v: Optional[torch.Tensor], *, q_offset,
                  sparsity: float = 0.0,
                  ctx_mask: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One DiT pass over a chunk.

    x_chunk [B, T_c, LATENT_CH]; t [B] denoise time; ctx_k/v
    [L, B, ctx_len, Hkv, Dh] visible context (or None).  Returns
    (prediction [B, T_c, LATENT_CH], {"k","v"} [L, B, T_c, Hkv, Dh]
    chunk KV).  ``q_offset`` is an int or a per-stream [B] tensor.
    ``ctx_mask`` [B, ctx_len] marks the context tokens each stream may
    attend to (the masked direct path of ``mha``); without it the
    static rho ``sparsity`` gather drops context tokens on the host
    side and attention runs unmasked (the flash kernel on the card).
    """
    b, tc, _ = x_chunk.shape
    keep_idx = None
    kv_mask = None
    if ctx_k is not None:
        if ctx_mask is not None:
            kv_mask = torch.cat([ctx_mask, torch.ones(
                (b, tc), dtype=torch.bool, device=ctx_mask.device)], dim=1)
        else:
            keep = cache_sparse_index(cfg, ctx_k.shape[2], sparsity)
            if keep is not None:
                keep_idx = torch.as_tensor(keep, device=ctx_k.device)

    def attend(li, q, k, v):
        if ctx_k is None:
            k_all, v_all = k, v
        else:
            kc, vc = ctx_k[li], ctx_v[li]
            if keep_idx is not None:
                kc, vc = kc[:, keep_idx], vc[:, keep_idx]
            k_all = torch.cat([kc.to(k.dtype), k], dim=1)
            v_all = torch.cat([vc.to(v.dtype), v], dim=1)
        return mha(q, k_all, v_all, n_kv_heads=cfg.n_kv_heads,
                   causal=False, kv_mask=kv_mask)

    return _dit_forward(cfg, p, x_chunk, t, q_offset, attend)


def denoise_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 t: torch.Tensor, dt: torch.Tensor, ctx_k: torch.Tensor,
                 ctx_v: torch.Tensor, q_offset: torch.Tensor,
                 dn_mask: Optional[torch.Tensor],
                 cl_mask: Optional[torch.Tensor], is_denoise: torch.Tensor):
    """Fused batched executor step over a gathered context (the
    ``gather`` context backend): forward + Euler update.  Rows in their
    denoise phase use ``dn_mask`` and a nonzero ``dt``; rows in their
    clean-context phase use ``cl_mask`` and dt=0 (their chunk KV is what
    matters).  A mask of None means every context token is visible to
    that phase; both None skips masking entirely."""
    if dn_mask is None and cl_mask is None:
        mask = None
    else:
        ones = torch.ones(ctx_k.shape[1:3], dtype=torch.bool,
                          device=ctx_k.device)
        mask = torch.where(is_denoise[:, None],
                           ones if dn_mask is None else dn_mask,
                           ones if cl_mask is None else cl_mask)
    v_pred, new_kv = chunk_forward(cfg, p, x, t, ctx_k, ctx_v,
                                   q_offset=q_offset, ctx_mask=mask)
    x_new = x - dt[:, None, None] * v_pred.to(x.dtype)
    return x_new, new_kv


# ---------------------------------------------------------------------------
# sequential serving: host-side cache bookkeeping + chunk generation
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, p: Params, cond: torch.Tensor,
               kv_dtype: Optional[str] = None) -> Dict[str, Any]:
    """Cache whose sink slot is the conditioning tokens.

    cond: [B, COND_TOKENS, d_model] (stub text-encoder output).
    ``len``/``chunks`` are host-side Python ints."""
    k, v = cond_kv(cfg, p, cond, kv_dtype)
    return {"k": k, "v": v, "len": COND_TOKENS, "chunks": 0}


def visible_context(cfg: ModelConfig, cache: Dict[str, Any],
                    window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sink + last ``window`` chunks of the cache (knob W)."""
    tc = chunk_tokens(cfg)
    ln = cache["len"]
    resident = (ln - COND_TOKENS) // tc
    w = min(window, resident)
    k, v = cache["k"], cache["v"]
    if w == resident:
        return k[:, :, :ln], v[:, :, :ln]
    lo = ln - w * tc
    return (torch.cat([k[:, :, :COND_TOKENS], k[:, :, lo:ln]], dim=2),
            torch.cat([v[:, :, :COND_TOKENS], v[:, :, lo:ln]], dim=2))


def append_chunk_kv(cfg: ModelConfig, cache: Dict[str, Any],
                    new_kv: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Append a chunk's KV; evict the oldest non-sink chunk when full."""
    tc = chunk_tokens(cfg)
    k, v = cache["k"], cache["v"]
    ln, nch = cache["len"], cache["chunks"]
    nk = new_kv["k"].to(k.dtype)    # [L,B,tc,H,Dh]
    nv = new_kv["v"].to(v.dtype)
    if ln + tc <= cache_capacity(cfg):
        return {"k": torch.cat([k[:, :, :ln], nk], dim=2),
                "v": torch.cat([v[:, :, :ln], nv], dim=2),
                "len": ln + tc, "chunks": nch + 1}
    sink = COND_TOKENS
    return {"k": torch.cat([k[:, :, :sink], k[:, :, sink + tc:ln], nk], 2),
            "v": torch.cat([v[:, :, :sink], v[:, :, sink + tc:ln], nv], 2),
            "len": ln, "chunks": nch + 1}


def serve_chunk(cfg: ModelConfig, p: Params, cache: Dict[str, Any],
                noise: torch.Tensor,
                fidelity: FidelityConfig = HIGHEST_QUALITY,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Generate one chunk under a fidelity configuration: ``steps``
    Euler steps over the visible context, then one clean-context pass
    whose KV (rounded through fp8-e4m3 under knob Q, with the
    reference's overflow semantics) is appended to the cache.

    noise: [B, T_c, LATENT_CH].  Returns (clean chunk latents, new cache).
    """
    tc = chunk_tokens(cfg)
    ctx_k, ctx_v = visible_context(cfg, cache, fidelity.window)
    q_offset = COND_TOKENS + cache["chunks"] * tc

    grid = sigma_schedule(fidelity.steps)
    x = noise
    b = noise.shape[0]
    for i in range(fidelity.steps):
        t = torch.full((b,), float(grid[i]), dtype=torch.float32,
                       device=noise.device)
        v_pred, _ = chunk_forward(cfg, p, x, t, ctx_k, ctx_v,
                                  q_offset=q_offset,
                                  sparsity=fidelity.sparsity)
        dt = float(grid[i] - grid[i + 1])
        x = x - dt * v_pred.to(x.dtype)         # Euler step toward data

    # context KV for future chunks comes from a clean-context pass
    t0 = torch.zeros((b,), dtype=torch.float32, device=noise.device)
    _, clean_kv = chunk_forward(cfg, p, x, t0, ctx_k, ctx_v,
                                q_offset=q_offset)
    if fidelity.quant == "fp8":
        clean_kv = {k_: kvcache.to_fp8_e4m3(v_)
                    for k_, v_ in clean_kv.items()}
    return x, append_chunk_kv(cfg, cache, clean_kv)


# ---------------------------------------------------------------------------
# page-table-native forward
# ---------------------------------------------------------------------------

def _chunk_forward_pages(cfg: ModelConfig, p: Params, x_chunk: torch.Tensor,
                         t: torch.Tensor, pools,
                         page_mask: Optional[torch.Tensor], *, q_offset,
                         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Shared body of the page-table-native forwards.

    ``pools`` is a tuple of ``(k_pages, v_pages, block_table, head_lo,
    head_hi)`` KV-head shards covering ``[0, n_kv_heads)``: one shard is
    the plain paged forward (no head slicing at all); two shards is
    elastic SP2, each shard's attention reading its own pool and table
    for its heads — the pool view ``pool[..., lo:hi, :]`` goes to the
    paged kernel as it is, with no copy (Ulysses head partition:
    per-head attention never mixes heads, so the sharded result equals
    the single-shard one whenever the shards mirror the same KV).
    """
    tc = x_chunk.shape[1]
    hkv = cfg.n_kv_heads
    hint = dict(sink=COND_TOKENS, chunk_tokens=tc)

    if len(pools) == 1:
        (k_pages, v_pages, table, _, _), = pools

        def attend(li, q, k, v):
            return paged_mha(q, k_pages[li], v_pages[li], table, page_mask,
                             k, v, n_kv_heads=hkv, **hint)
    else:
        def attend(li, q, k, v):
            outs = [paged_mha(shard_heads(q, hkv, lo, hi).contiguous(),
                              kp[li][..., lo:hi, :], vp[li][..., lo:hi, :],
                              tbl, page_mask, shard_heads(k, hkv, lo, hi),
                              shard_heads(v, hkv, lo, hi),
                              n_kv_heads=hi - lo, **hint)
                    for kp, vp, tbl, lo, hi in pools]
            return merge_head_shards(outs, [hi - lo for *_, lo, hi in pools])

    return _dit_forward(cfg, p, x_chunk, t, q_offset, attend)


def chunk_forward_paged(cfg: ModelConfig, p: Params, x_chunk: torch.Tensor,
                        t: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        page_mask: Optional[torch.Tensor], *, q_offset,
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One DiT pass over a chunk with the cached context consumed IN
    PLACE from the paged KV pool.

    x_chunk [B, T_c, LATENT_CH]; t [B]; k_pages/v_pages [L, n_pages,
    page, Hkv, Dh] — the whole pool; block_table [B, n] per-stream page
    tables (entry 0 = sink page, entry 1+r = ring slot r); page_mask
    [B, n*page] visible context tokens in table order, or None when
    every valid token is visible.  ``q_offset`` is an int or a
    per-stream [B] tensor.  Returns (prediction [B, T_c, LATENT_CH],
    {"k","v"} [L, B, T_c, Hkv, Dh] chunk KV).
    """
    return _chunk_forward_pages(
        cfg, p, x_chunk, t,
        ((k_pages, v_pages, block_table, 0, cfg.n_kv_heads),),
        page_mask, q_offset=q_offset)


def denoise_step_paged(cfg: ModelConfig, p: Params, x: torch.Tensor,
                       t: torch.Tensor, dt: torch.Tensor,
                       k_pages: torch.Tensor, v_pages: torch.Tensor,
                       block_table: torch.Tensor,
                       dn_mask: Optional[torch.Tensor],
                       cl_mask: Optional[torch.Tensor],
                       q_offset: torch.Tensor, is_denoise: torch.Tensor):
    """Fused batched executor step over the paged pool: forward + Euler
    update.  Rows in their denoise phase use ``dn_mask`` and a nonzero
    ``dt``; rows in their clean-context phase use ``cl_mask`` and dt=0
    (their chunk KV is what matters).  ``dn_mask=None`` is the
    all-visible fast path (homogeneous fill, full window, no sparsity;
    it implies cl all-visible, since the clean window is a superset);
    ``cl_mask=None`` means the clean pass sees exactly the denoise
    mask."""
    mask = dn_mask if cl_mask is None else \
        torch.where(is_denoise[:, None], dn_mask, cl_mask)
    v_pred, new_kv = chunk_forward_paged(cfg, p, x, t, k_pages, v_pages,
                                         block_table, mask,
                                         q_offset=q_offset)
    x_new = x - dt[:, None, None] * v_pred.to(x.dtype)
    return x_new, new_kv


def chunk_forward_paged_sp(cfg: ModelConfig, p: Params,
                           x_chunk: torch.Tensor, t: torch.Tensor,
                           k_home: torch.Tensor, v_home: torch.Tensor,
                           k_donor: torch.Tensor, v_donor: torch.Tensor,
                           table_home: torch.Tensor,
                           table_donor: torch.Tensor,
                           page_mask: Optional[torch.Tensor], *, q_offset,
                           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """SP2 sibling of ``chunk_forward_paged``: the stream's KV heads are
    Ulysses-partitioned across two lanes (paper SS4.3 / App. C.4).

    The home lane's pool ``k_home``/``v_home`` is the system of record
    (full heads); the donor lane's pool ``k_donor``/``v_donor`` carries
    the stream's UPPER half heads in its own page set (``table_donor``).
    The home shard reads heads [0, H/2) from the home pool and the donor
    shard heads [H/2, H) from the donor pool, each through a head-range
    view of its pool, and the outputs concatenate back into full-head
    order.  Per-head attention never mixes heads, so the result equals
    the SP1 ``chunk_forward_paged`` whenever the donor's half mirrors
    the home pool's upper half.
    """
    hkv = cfg.n_kv_heads
    h2 = hkv // 2
    if hkv % 2:
        raise ValueError(f"SP2 head split needs even n_kv_heads ({hkv})")
    return _chunk_forward_pages(
        cfg, p, x_chunk, t,
        ((k_home, v_home, table_home, 0, h2),
         (k_donor, v_donor, table_donor, h2, hkv)),
        page_mask, q_offset=q_offset)


def denoise_step_paged_sp(cfg: ModelConfig, p: Params, x: torch.Tensor,
                          t: torch.Tensor, dt: torch.Tensor,
                          k_home: torch.Tensor, v_home: torch.Tensor,
                          k_donor: torch.Tensor, v_donor: torch.Tensor,
                          table_home: torch.Tensor,
                          table_donor: torch.Tensor,
                          dn_mask: Optional[torch.Tensor],
                          cl_mask: Optional[torch.Tensor],
                          q_offset: torch.Tensor, is_denoise: torch.Tensor):
    """Elastic-SP2 sibling of ``denoise_step_paged``: one stream's
    denoise step with its KV heads split across the home and donor
    lanes' pools.  Mask semantics match ``denoise_step_paged``.  The
    kernels are instantiated per head dim, not per head count, so the
    half-head shards need no warm-up of their own."""
    mask = dn_mask if cl_mask is None else \
        torch.where(is_denoise[:, None], dn_mask, cl_mask)
    v_pred, new_kv = chunk_forward_paged_sp(
        cfg, p, x, t, k_home, v_home, k_donor, v_donor, table_home,
        table_donor, mask, q_offset=q_offset)
    x_new = x - dt[:, None, None] * v_pred.to(x.dtype)
    return x_new, new_kv


# ---------------------------------------------------------------------------
# batched serving: per-stream sink KV + ring visibility masks
# ---------------------------------------------------------------------------

def cond_kv(cfg: ModelConfig, p: Params, cond: torch.Tensor,
            kv_dtype: Optional[str] = None):
    """Sink (conditioning) KV of a batch of streams: cond [B,
    COND_TOKENS, d_model] -> k, v [L, B, COND_TOKENS, Hkv, Dh] in the
    KV dtype.  ``KVPool`` writes this into a stream's sink page."""
    dt = DTYPES[kv_dtype or cfg.kv_dtype]
    cond = cond.to(p["cond_proj"].dtype) @ p["cond_proj"]
    positions = torch.arange(COND_TOKENS, device=cond.device)
    ks, vs = [], []
    for lp in L.unstack(p["layers"], cfg.n_layers):
        _, k, v = L.attn_qkv(cfg, lp["attn"], cond, positions)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks).to(dt), torch.stack(vs).to(dt)


def init_batched_cache(cfg: ModelConfig, p: Params, cond: torch.Tensor,
                       kv_dtype: Optional[str] = None) -> Dict[str, Any]:
    """Fixed-capacity ring cache for a batch of streams: {"k","v"} of
    [L, B, cap, Hkv, Dh] (sink KV, zero ring) plus host-side per-stream
    chunk counts ``chunks`` [B]."""
    k, v = cond_kv(cfg, p, cond, kv_dtype)
    pad = (0, 0, 0, 0, 0, cache_capacity(cfg) - COND_TOKENS)
    return {"k": F.pad(k, pad), "v": F.pad(v, pad),
            "chunks": np.zeros(cond.shape[0], np.int64)}


def batched_context_mask(cfg: ModelConfig, chunks: np.ndarray, window: int,
                         sparsity: float = 0.0) -> np.ndarray:
    """Per-stream context-visibility mask [B, cap] over the ring cache:
    the sink tokens plus the tokens of each stream's last
    ``min(window, resident)`` chunks that survive the rho sparsity drop,
    mapped through the ring permutation."""
    n = len(np.asarray(chunks, np.int64))
    return batched_context_mask_multi(
        cfg, chunks, np.full(n, window, np.int64),
        np.full(n, sparsity, np.float64))


def batched_context_mask_multi(cfg: ModelConfig, chunks: np.ndarray,
                               windows: np.ndarray,
                               sparsities: np.ndarray) -> np.ndarray:
    """``batched_context_mask`` with PER-ROW window/sparsity knobs (the
    fused heterogeneous-fidelity dispatch): row i is what its own
    fidelity's uniform mask would be."""
    tc = chunk_tokens(cfg)
    w_max = cfg.ardit_window_chunks
    mask = np.zeros((len(chunks), cache_capacity(cfg)), bool)
    windows = np.asarray(windows, np.int64)
    sparsities = np.asarray(sparsities, np.float64)
    for i, n in enumerate(np.asarray(chunks, np.int64)):
        w = min(int(windows[i]), int(n), w_max)
        ctx_len = COND_TOKENS + w * tc
        keep = cache_sparse_index(cfg, ctx_len, float(sparsities[i]))
        idx = np.arange(ctx_len) if keep is None else keep
        mask[i, idx[idx < COND_TOKENS]] = True
        body = idx[idx >= COND_TOKENS] - COND_TOKENS
        if w and body.size:
            c_abs = (int(n) - w) + body // tc       # absolute chunk index
            slot = COND_TOKENS + (c_abs % w_max) * tc + body % tc
            mask[i, slot] = True
    return mask


def chunk_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
               t: torch.Tensor, ctx_k: Optional[torch.Tensor],
               ctx_v: Optional[torch.Tensor], q_offset,
               ctx_mask: Optional[torch.Tensor], sparsity: float = 0.0):
    """One denoise-step forward of the ring batched path (the
    reference's jitted entry; eager here): ``chunk_forward`` over the
    ring with the per-row ``ctx_mask``."""
    return chunk_forward(cfg, p, x, t, ctx_k, ctx_v, q_offset=q_offset,
                         sparsity=sparsity, ctx_mask=ctx_mask)


def append_chunk_kv_batched(cfg: ModelConfig, cache: Dict[str, Any],
                            new_kv: Dict[str, torch.Tensor]
                            ) -> Dict[str, Any]:
    """Ring-write one new chunk of KV per stream at its own slot (IN
    PLACE into ``cache``'s tensors; the host-side chunk counts advance
    in the returned dict)."""
    chunks = np.asarray(cache["chunks"], np.int64)
    dest = torch.as_tensor(kvcache.chunk_slot(
        chunks, cfg.ardit_window_chunks, COND_TOKENS, chunk_tokens(cfg)))
    return {"k": kvcache.write_block_layers(cache["k"], new_kv["k"], dest),
            "v": kvcache.write_block_layers(cache["v"], new_kv["v"], dest),
            "chunks": chunks + 1}


def serve_chunk_batched(cfg: ModelConfig, p: Params, cache: Dict[str, Any],
                        noise: torch.Tensor,
                        fidelity: FidelityConfig = HIGHEST_QUALITY,
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One chunk for every stream of a ring batched cache under one
    shared fidelity configuration (one same-fidelity sub-batch).

    noise: [B, T_c, LATENT_CH]; streams may sit at different chunk
    indices.  Per stream, ``serve_chunk``'s function: ``steps`` Euler
    steps over the denoise mask, then a clean-context pass over the
    full (unsparsified) window whose KV (rounded through fp8-e4m3 under
    knob Q, with the reference's overflow semantics) is ring-written
    into the cache."""
    tc = chunk_tokens(cfg)
    dev = noise.device
    b = noise.shape[0]
    chunks = np.asarray(cache["chunks"], np.int64)
    q_offset = torch.as_tensor(COND_TOKENS + chunks * tc,
                               dtype=torch.int32, device=dev)
    dn_mask = torch.as_tensor(batched_context_mask(
        cfg, chunks, fidelity.window, fidelity.sparsity), device=dev)

    grid = sigma_schedule(fidelity.steps)
    x = noise
    for i in range(fidelity.steps):
        t = torch.full((b,), float(grid[i]), dtype=torch.float32,
                       device=dev)
        v_pred, _ = chunk_step(cfg, p, x, t, cache["k"], cache["v"],
                               q_offset, dn_mask)
        dt = float(grid[i] - grid[i + 1])
        x = x - dt * v_pred.to(x.dtype)

    # the clean-context pass sees the full (unsparsified) window
    clean_mask = torch.as_tensor(batched_context_mask(
        cfg, chunks, fidelity.window), device=dev)
    t0 = torch.zeros((b,), dtype=torch.float32, device=dev)
    _, clean_kv = chunk_step(cfg, p, x, t0, cache["k"], cache["v"],
                             q_offset, clean_mask)
    if fidelity.quant == "fp8":
        clean_kv = {k_: kvcache.to_fp8_e4m3(v_)
                    for k_, v_ in clean_kv.items()}
    return x, append_chunk_kv_batched(cfg, cache, clean_kv)


# ---------------------------------------------------------------------------
# training: causal-forcing style denoising over a chunk sequence
# ---------------------------------------------------------------------------

def train_loss(cfg: ModelConfig, p: Params,
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Flow-matching loss over a sequence of chunks with causal context.

    batch: latents [B, n_chunks, T_c, LATENT_CH], cond [B, 77, d_model],
    t [B, n_chunks] denoise times, noise (same shape as latents).
    Chunks run in a Python loop over a growing context, the
    teacher-forced analogue of ``serve_chunk``'s rolling window: the
    noised chunk's velocity against the rectified-flow target
    ``eps - x0``, then a clean pass whose KV joins the context through
    the functional ``append_chunk_kv`` (``torch.cat``, so gradients flow
    through the context into earlier chunks)."""
    lat, cond = batch["latents"], batch["cond"]
    t_all, noise = batch["t"], batch["noise"]
    n_chunks = lat.shape[1]
    cache = init_cache(cfg, p, cond)
    total = torch.zeros((), dtype=torch.float32, device=lat.device)
    for c in range(n_chunks):
        x0, eps, t = lat[:, c], noise[:, c], t_all[:, c]
        x_t = (1.0 - t[:, None, None]) * x0 + t[:, None, None] * eps
        target = eps - x0                       # rectified-flow velocity
        ctx_k, ctx_v = visible_context(cfg, cache, cfg.ardit_window_chunks)
        q_offset = COND_TOKENS + c * chunk_tokens(cfg)
        pred, _ = chunk_forward(cfg, p, x_t, t, ctx_k, ctx_v,
                                q_offset=q_offset)
        total = total + torch.mean((pred.float() - target.float()) ** 2)
        # the clean pass provides the causal context for the next chunk
        _, clean_kv = chunk_forward(cfg, p, x0, torch.zeros_like(t),
                                    ctx_k, ctx_v, q_offset=q_offset)
        cache = append_chunk_kv(cfg, cache, clean_kv)
    return total / n_chunks
