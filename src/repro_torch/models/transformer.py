"""Dense / MoE / VLM decoder-only transformer: init, forward and the
serving surface (prefill, decode), a port of the JAX reference's
``models/transformer.py``.

The stacked ``[L, ...]`` layer parameters are consumed by a Python loop
(the reference's ``lax.scan``); the reference's ``shard`` annotations
are identity on one device and are dropped.  Prefill attention goes
through ``attention.mha`` at the reference's blocks of 512, so on the
card it is the flash kernel (``kernels/flash_attention``) in the mode
``attention.flash_mode`` computes; decode attention is the plain
``attention.decode_attention`` on every device, as in the reference
(whose decode never calls a Pallas kernel).  Training: ``forward``
with ``remat`` checkpoints each layer (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``) and rounds the layer boundary's
gradient through bf16 under ``cfg.bf16_backward``; ``chunked_ce`` and
``train_loss`` as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.precision import bf16_cotangent
from repro_torch.models import kvcache
from repro_torch.models import layers as L
from repro_torch.models.attention import decode_attention, mha

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(cfg: ModelConfig, gen: torch.Generator, dtype,
               device="cpu") -> Params:
    p = {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": L.init_attn(cfg, gen, dtype, device),
    }
    if cfg.n_experts:
        p["moe"] = L.init_moe(cfg, gen, dtype, device)
    else:
        p["mlp"] = L.init_mlp(cfg, gen, dtype, device)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device="cuda") -> Params:
    """Fresh parameters: the reference's shapes, dtypes and scales,
    drawn from ``generator`` on its own device (a CUDA generator draws
    on the card; values do not depend on the target device), one layer
    at a time into the stacked ``[L, ...]`` layout.  On ``"meta"``
    nothing is drawn (``generator`` may be None)."""
    dtype = L.DTYPES[cfg.param_dtype]
    p: Params = {
        "embed": L.dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                              dtype, scale=0.02, device=device),
        "layers": L.init_stacked(
            cfg.n_layers, lambda: init_layer(cfg, generator, dtype, device)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                    dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, p: Params, tokens: torch.Tensor,
           img_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    h = p["embed"][tokens.long()]
    if img_embeds is not None:                       # VLM: prepend patch stub
        h = torch.cat([img_embeds.to(h.dtype), h], dim=1)
    return h


def _unembed(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(h, p["final_norm"], cfg.norm_eps)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return h @ w


def _ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    f_in = L.rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
    return h + L.ffn_block(cfg, lp["moe"] if cfg.n_experts else lp["mlp"],
                           f_in, bool(cfg.n_experts))


def _layer_fwd(cfg: ModelConfig, lp: Params, h: torch.Tensor, *,
               positions: torch.Tensor, q_offset: int = 0,
               window: int = 0, sink: int = 0, sparsity: float = 0.0,
               block_q: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    a_in = L.rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + L.attn_block(cfg, lp["attn"], a_in, positions=positions,
                         q_offset=q_offset, window=window, sink=sink,
                         sparsity=sparsity, block_q=block_q)
    h = _ffn(cfg, lp, h)
    aux = L.moe_block.last_aux if cfg.n_experts \
        else torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def forward(cfg: ModelConfig, p: Params, tokens: torch.Tensor, *,
            img_embeds: Optional[torch.Tensor] = None,
            window: int = 0, sink: int = 0, sparsity: float = 0.0,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (hidden [B,S,D], moe_aux scalar).
    ``remat`` recomputes each layer in the backward pass."""
    h = _embed(cfg, p, tokens, img_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    window = window or cfg.attn_window
    sink = sink or cfg.attn_sink
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in L.unstack(p["layers"], cfg.n_layers):

        def body(hh, lp=lp):
            hh, a = _layer_fwd(cfg, lp, hh, positions=positions,
                               window=window, sink=sink, sparsity=sparsity)
            if cfg.bf16_backward:
                hh = bf16_cotangent(hh)
            return hh, a

        h, a = L.remat_call(remat, body, h)
        aux = aux + a
    return h, aux


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def chunked_ce(logits_fn, h: torch.Tensor, targets: torch.Tensor,
               mask: Optional[torch.Tensor], block: int = 1024
               ) -> torch.Tensor:
    """Cross-entropy computed in blocks of ``block`` positions along S,
    to bound the logits working set: the sum of each block's masked
    losses and of its mask, then one divide (the reference's order),
    the remainder block last."""
    b, s, _ = h.shape
    block = min(block, s)
    n = s // block
    rem = s - n * block
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=h.device)

    def ce_block(h_blk, t_blk, m_blk):
        logits = logits_fn(h_blk).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t_blk.long()[..., None])[..., 0]
        return torch.sum((lse - gold) * m_blk), torch.sum(m_blk)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    spans = [(i * block, (i + 1) * block) for i in range(n)]
    if rem:
        spans.append((n * block, s))
    for lo, hi in spans:
        s_, c_ = ce_block(h[:, lo:hi], targets[:, lo:hi], mask[:, lo:hi])
        tot, cnt = tot + s_, cnt + c_
    return tot / torch.clamp(cnt, min=1.0)


def train_loss(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
               aux_weight: float = 0.01, remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy (VLM: text positions only) plus the MoE
    load-balancing aux loss times ``aux_weight``; tied embeddings
    (minicpm-2b) unembed with ``embed``.  ``remat`` as the reference
    (on)."""
    img = batch.get("img_embeds")
    h, aux = forward(cfg, p, batch["tokens"], img_embeds=img, remat=remat)
    if img is not None:                 # loss only on text positions
        h = h[:, img.shape[1]:]
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    loss = chunked_ce(lambda hb: L.rmsnorm(hb, p["final_norm"],
                                           cfg.norm_eps) @ w,
                      h, batch["targets"], batch.get("loss_mask"))
    return loss + aux_weight * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    cap = kvcache.capacity(max_len, cfg.attn_window, cfg.attn_sink)
    shp = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    kv_dtype = L.DTYPES[cfg.kv_dtype]
    return {"k": torch.zeros(shp, dtype=kv_dtype, device=device),
            "v": torch.zeros(shp, dtype=kv_dtype, device=device)}


def prefill(cfg: ModelConfig, p: Params, tokens: torch.Tensor, *,
            img_embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None,
            window: int = 0, sink: int = 0, sparsity: float = 0.0):
    """Returns (last-position logits [B,V], cache, cache_len [B])."""
    h = _embed(cfg, p, tokens, img_embeds)
    b, s, _ = h.shape
    max_len = max_len or s
    window = window or cfg.attn_window
    sink = sink or cfg.attn_sink
    cap = kvcache.capacity(max_len, window, sink)
    positions = torch.arange(s, device=h.device)
    shp = (cfg.n_layers, b, cap, cfg.n_kv_heads, cfg.head_dim)
    # every slot is written below (place_prefill pads with zeros)
    cache = {n: torch.empty(shp, dtype=L.DTYPES[cfg.kv_dtype],
                            device=h.device) for n in ("k", "v")}
    for i in range(cfg.n_layers):
        lp = L.layer_params(p, i)
        a_in = L.rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = L.attn_qkv(cfg, lp["attn"], a_in, positions)
        o = mha(q, k, v, n_kv_heads=cfg.n_kv_heads, causal=True,
                window=window, sink=sink, sparsity=sparsity)
        h = h + o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp["attn"]["wo"]
        h = _ffn(cfg, lp, h)
        kvcache.write_cast(cache["k"][i],
                           kvcache.place_prefill(k, cap, sink, window))
        kvcache.write_cast(cache["v"][i],
                           kvcache.place_prefill(v, cap, sink, window))
    logits = _unembed(cfg, p, h[:, -1:])[:, 0]
    cache_len = torch.full((b,), s, dtype=torch.int32, device=h.device)
    return logits, cache, cache_len


def decode_step(cfg: ModelConfig, p: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: torch.Tensor, *,
                window: int = 0, sink: int = 0):
    """One decode step.  token [B,1], pos [B] (write position = current len).

    With a ring cache (cap == sink + window < seq_len) eviction replaces
    masking; with a full-length cache the window mask applies.  Returns
    (logits [B,V], cache): the new token's K/V are written into the
    given cache IN PLACE and the same tensors are returned (the
    reference returns an updated copy; a copy per token of a full-width
    cache would swamp decode).
    """
    h = _embed(cfg, p, token, None)
    b = token.shape[0]
    positions = pos[:, None]
    window = window or cfg.attn_window
    sink = sink or cfg.attn_sink
    cap = cache["k"].shape[2]
    ring_mode = bool(window) and cap == sink + window
    dest = kvcache.ring_dest(pos, cap, sink) if ring_mode else pos
    cache_len = kvcache.n_valid(pos, cap)
    for i in range(cfg.n_layers):
        lp = L.layer_params(p, i)
        a_in = L.rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = L.attn_qkv(cfg, lp["attn"], a_in, positions)
        kc = kvcache.write_token(cache["k"][i], k, dest)
        vc = kvcache.write_token(cache["v"][i], v, dest)
        o = decode_attention(q, kc, vc, n_kv_heads=cfg.n_kv_heads,
                             cache_len=cache_len,
                             window=0 if ring_mode else window, sink=sink)
        h = h + o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ lp["attn"]["wo"]
        h = _ffn(cfg, lp, h)
    return _unembed(cfg, p, h)[:, 0], cache
