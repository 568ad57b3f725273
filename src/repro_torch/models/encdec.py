"""Whisper-style encoder-decoder: init, encoder, decoder forward and the
serving surface (prefill, decode), a port of the JAX reference's
``models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, n_frontend_tokens, d_model].  The
decoder is a causal transformer with cross-attention over the encoder
states; RoPE stands in for Whisper's learned positional tables, as
there.  Both stacks norm with ``layers.rmsnorm``.  Every attention of
the encoder and of a prefill goes through ``attention.mha`` (the flash
kernel on the card): the encoder's non-causal self-attention, the
decoder's causal self-attention at the reference's blocks of 512 and
the cross-attention (``_cross_attn``, non-causal over the precomputed
``_cross_kv``).  A decode step's cross-attention is ``mha`` too, with
one query row; its self-attention is the plain
``attention.decode_attention``, as in the reference and the other
families.  The stacked ``enc_layers`` / ``dec_layers`` parameters are
consumed by Python loops (the reference's ``lax.scan``).  Training:
``forward(remat=True)`` checkpoints each decoder layer with its
cross-attention K/V (the encoder is not checkpointed, as in the
reference) and ``train_loss`` is the reference's cross-entropy.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import logical
from repro_torch.distributed.logical import shard
from repro_torch.models import kvcache
from repro_torch.models import layers as L
from repro_torch.models.attention import decode_attention, mha

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _ones(cfg: ModelConfig, dtype, device) -> torch.Tensor:
    return torch.ones((cfg.d_model,), dtype=dtype, device=device)


def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator, dtype,
                    device) -> Params:
    return {"attn_norm": _ones(cfg, dtype, device),
            "mlp_norm": _ones(cfg, dtype, device),
            "attn": L.init_attn(cfg, gen, dtype, device),
            "mlp": L.init_mlp(cfg, gen, dtype, device)}


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator, dtype,
                    device) -> Params:
    return {"attn_norm": _ones(cfg, dtype, device),
            "cross_norm": _ones(cfg, dtype, device),
            "mlp_norm": _ones(cfg, dtype, device),
            "attn": L.init_attn(cfg, gen, dtype, device),
            "cross": L.init_attn(cfg, gen, dtype, device),
            "mlp": L.init_mlp(cfg, gen, dtype, device)}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device="cuda") -> Params:
    """Fresh parameters: the reference's shapes, dtypes and scales,
    drawn from ``generator`` on its own device, one layer at a time
    into the stacked ``enc_layers`` / ``dec_layers`` layout.  On
    ``"meta"`` nothing is drawn (``generator`` may be None)."""
    dtype = L.DTYPES[cfg.param_dtype]
    return {
        "embed": L.dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                              dtype, scale=0.02, device=device),
        "enc_layers": L.init_stacked(
            cfg.n_enc_layers,
            lambda: _init_enc_layer(cfg, generator, dtype, device)),
        "dec_layers": L.init_stacked(
            cfg.n_dec_layers,
            lambda: _init_dec_layer(cfg, generator, dtype, device)),
        "enc_final_norm": _ones(cfg, dtype, device),
        "final_norm": _ones(cfg, dtype, device),
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                dtype, device=device),
    }


def _layer(stack: Params, i: int) -> Params:
    return L.tree_map(lambda t: L.logical.gather_weight(t[i]), stack)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, p: Params,
           audio_embeds: torch.Tensor) -> torch.Tensor:
    """audio_embeds [B, T_a, D] (stub frontend output) -> encoder
    states [B, T_a, D]."""
    h = shard(audio_embeds.to(L.DTYPES[cfg.param_dtype]),
              "batch", None, "embed")
    positions = torch.arange(h.shape[1], device=h.device)
    for lp in L.unstack(p["enc_layers"], cfg.n_enc_layers):
        a_in = L.rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
        h = h + L.attn_block(cfg, lp["attn"], a_in, positions=positions,
                             causal=False)
        f_in = L.rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
        h = h + L.mlp_block(cfg, lp["mlp"], f_in)
    return L.rmsnorm(h, p["enc_final_norm"], cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, lp: Params, enc: torch.Tensor):
    """Cross-attention K/V [B, T_a, Hkv, Dh] from encoder states (no
    RoPE)."""
    b, t, _ = enc.shape
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    k = enc @ lp["wk"]
    v = enc @ lp["wv"]
    if cfg.qkv_bias:
        k = k + lp["bk"]
        v = v + lp["bv"]
    return k.reshape(b, t, hkv, dh), v.reshape(b, t, hkv, dh)


def _cross_attn(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention of x's queries over precomputed K/V (a
    cache's K/V in another dtype is widened to the queries', exactly)."""
    b, s, _ = x.shape
    hq, dh = cfg.n_heads, cfg.head_dim
    q = x @ lp["wq"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
    q = q.reshape(b, s, hq, dh)
    o = mha(q, k.to(q.dtype), v.to(q.dtype), n_kv_heads=cfg.n_kv_heads,
            causal=False)
    return o.reshape(b, s, hq * dh) @ lp["wo"]


# ---------------------------------------------------------------------------
# decoder: forward / prefill / decode
# ---------------------------------------------------------------------------

def _dec_layer(cfg: ModelConfig, lp: Params, h: torch.Tensor, *,
               positions: torch.Tensor, cross_k: torch.Tensor,
               cross_v: torch.Tensor, sparsity: float = 0.0,
               window: int = 0, sink: int = 0) -> torch.Tensor:
    a_in = L.rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + L.attn_block(cfg, lp["attn"], a_in, positions=positions,
                         window=window, sink=sink, sparsity=sparsity)
    c_in = L.rmsnorm(h, lp["cross_norm"], cfg.norm_eps)
    h = h + _cross_attn(cfg, lp["cross"], c_in, cross_k, cross_v)
    f_in = L.rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
    return h + L.mlp_block(cfg, lp["mlp"], f_in)


def forward(cfg: ModelConfig, p: Params, tokens: torch.Tensor,
            audio_embeds: torch.Tensor, *, sparsity: float = 0.0,
            remat: bool = False) -> torch.Tensor:
    """Decoder hidden states [B, S, D] over the whole token sequence.
    ``remat`` recomputes each decoder layer (its cross K/V included) in
    the backward pass."""
    enc = encode(cfg, p, audio_embeds)
    h = shard(L.embed_lookup(p["embed"], tokens), "batch", None, "embed")
    positions = torch.arange(h.shape[1], device=h.device)
    for lp in L.unstack(p["dec_layers"], cfg.n_dec_layers):

        def body(hh, lp=lp):
            ck, cv = _cross_kv(cfg, lp["cross"], enc)
            return _dec_layer(cfg, lp, hh, positions=positions, cross_k=ck,
                              cross_v=cv, sparsity=sparsity)

        h = L.remat_call(remat, body, h)
    return h


def _unembed(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(h, p["final_norm"], cfg.norm_eps)
    return shard(h @ p["lm_head"], "batch", None, "vocab")


def train_loss(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
               remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy of the decoder over the encoded
    ``audio_embeds``; ``remat`` as the reference (on)."""
    from repro_torch.models.transformer import chunked_ce
    h = forward(cfg, p, batch["tokens"], batch["audio_embeds"], remat=remat)
    return chunked_ce(
        lambda hb: L.rmsnorm(hb, p["final_norm"], cfg.norm_eps) @ p["lm_head"],
        h, batch["targets"], batch.get("loss_mask"))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               enc_len: Optional[int] = None,
               like: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Self-attention ``k`` / ``v`` [L_dec, B, max_len, Hkv, Dh] and
    cross-attention ``ck`` / ``cv`` [L_dec, B, enc_len, Hkv, Dh], zeros
    in the KV dtype (under a mesh and with a DTensor ``like``, DTensors
    laid out as the prefill's ``shard`` of its K/V)."""
    enc_len = enc_len or cfg.n_frontend_tokens
    kv_dtype = L.DTYPES[cfg.kv_dtype]
    hkv, dh = cfg.n_kv_heads, cfg.head_dim

    def zeros(n):
        shp = (cfg.n_dec_layers, batch, n, hkv, dh)
        if like is not None:
            return logical.empty(shp, kv_dtype, like, (
                None, "batch", "seq_kv", "kv_heads", None)).zero_()
        return torch.zeros(shp, dtype=kv_dtype, device=device)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "ck": zeros(enc_len), "cv": zeros(enc_len)}


def prefill(cfg: ModelConfig, p: Params, tokens: torch.Tensor, *,
            audio_embeds: torch.Tensor, max_len: Optional[int] = None,
            sparsity: float = 0.0, **_):
    """Returns (last-position logits [B, V], cache {self k / v padded to
    ``max_len``, cross ck / cv}, cache_len [B])."""
    b, s = tokens.shape
    max_len = max_len or s
    enc = encode(cfg, p, audio_embeds)
    h = L.embed_lookup(p["embed"], tokens)
    positions = torch.arange(s, device=h.device)
    cache = init_cache(cfg, b, max_len, device=h.device,
                       enc_len=enc.shape[1], like=h)
    for i in range(cfg.n_dec_layers):
        lp = _layer(p["dec_layers"], i)
        ck, cv = _cross_kv(cfg, lp["cross"], enc)
        a_in = L.rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = L.attn_qkv(cfg, lp["attn"], a_in, positions)
        o = mha(q, k, v, n_kv_heads=cfg.n_kv_heads, causal=True,
                sparsity=sparsity)
        h = h + o.reshape(b, s, cfg.n_heads * cfg.head_dim) \
            @ lp["attn"]["wo"]
        c_in = L.rmsnorm(h, lp["cross_norm"], cfg.norm_eps)
        h = h + _cross_attn(cfg, lp["cross"], c_in, ck, cv)
        f_in = L.rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
        h = h + L.mlp_block(cfg, lp["mlp"], f_in)
        kvcache.write_cast(cache["k"][i, :, :s],
                           shard(k, "batch", "seq_kv", "kv_heads", None))
        kvcache.write_cast(cache["v"][i, :, :s],
                           shard(v, "batch", "seq_kv", "kv_heads", None))
        kvcache.write_cast(cache["ck"][i], ck)
        kvcache.write_cast(cache["cv"][i], cv)
    logits = _unembed(cfg, p, h[:, -1:])[:, 0]
    return logits, cache, torch.full((b,), s, dtype=torch.int32,
                                     device=h.device)


def decode_step(cfg: ModelConfig, p: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: torch.Tensor, **_):
    """One decoder step.  token [B, 1], pos [B] (write position = current
    length).  Returns (logits [B, V], cache): the new token's self K/V
    are written into the given cache IN PLACE and the same tensors are
    returned, as the port's ``transformer.decode_step`` does."""
    b = token.shape[0]
    h = L.embed_lookup(p["embed"], token)
    positions = pos[:, None]
    for i in range(cfg.n_dec_layers):
        lp = _layer(p["dec_layers"], i)
        a_in = L.rmsnorm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = L.attn_qkv(cfg, lp["attn"], a_in, positions)
        kc = kvcache.write_token(cache["k"][i], k, pos)
        vc = kvcache.write_token(cache["v"][i], v, pos)
        o = decode_attention(q, kc, vc, n_kv_heads=cfg.n_kv_heads,
                             cache_len=pos + 1)
        h = h + o.reshape(b, 1, cfg.n_heads * cfg.head_dim) \
            @ lp["attn"]["wo"]
        c_in = L.rmsnorm(h, lp["cross_norm"], cfg.norm_eps)
        h = h + _cross_attn(cfg, lp["cross"], c_in, cache["ck"][i],
                            cache["cv"][i])
        f_in = L.rmsnorm(h, lp["mlp_norm"], cfg.norm_eps)
        h = h + L.mlp_block(cfg, lp["mlp"], f_in)
    return _unembed(cfg, p, h)[:, 0], cache
