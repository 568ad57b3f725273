"""Jamba-style hybrid model: Mamba + attention interleave with MoE, a
port of the JAX reference's ``models/hybrid.py`` (serving surface).

Layer l is an attention layer iff ``l % attn_every == attn_every // 2``;
the FFN is MoE iff ``l % moe_every == moe_every - 1`` (Jamba places MoE on
every other layer).  Layers are grouped into *periods* of
``lcm(attn_every, moe_every)`` sublayers; per-period params are stacked
``[n_periods, ...]`` under ``periods/sub{j}`` and consumed by a Python
loop (the reference's ``lax.scan``).

Attention layers keep a bounded sink+window KV cache (a ring buffer at
decode time); prefill attention is ``attention.mha`` in its sink +
window schedule (the flash kernel on the card), the Mamba sublayers run
``ssm.mamba_block`` (the SSD kernel on the card) and decode
``ssm.mamba_decode`` and the plain ``attention.decode_attention``.
``train_loss`` trains through the plain SSD on the CPU; on the card the
SSD kernel has no backward yet and its wrapper raises under grad.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.logical import shard
from repro_torch.models import kvcache
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.attention import decode_attention, mha

Params = Dict[str, Any]


def period_len(cfg: ModelConfig) -> int:
    return math.lcm(cfg.attn_every, cfg.moe_every or 1)


def sublayer_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """[(mixer, ffn)] per sublayer within one period."""
    out = []
    for j in range(period_len(cfg)):
        mixer = ("attn" if j % cfg.attn_every == cfg.attn_every // 2
                 else "mamba")
        ffn = ("moe" if cfg.n_experts and
               j % cfg.moe_every == cfg.moe_every - 1 else "mlp")
        out.append((mixer, ffn))
    return out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_period(cfg: ModelConfig, gen: Optional[torch.Generator], dtype,
                device="cpu") -> Params:
    p: Params = {}
    for j, (mixer, ffn) in enumerate(sublayer_kinds(cfg)):
        sub: Params = {
            "mixer_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                     device=device),
            "ffn_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                   device=device),
        }
        if mixer == "attn":
            sub["attn"] = L.init_attn(cfg, gen, dtype, device)
        else:
            sub["mamba"] = S.init_mamba(cfg, gen, dtype, device)
        if ffn == "moe":
            sub["moe"] = L.init_moe(cfg, gen, dtype, device)
        else:
            sub["mlp"] = L.init_mlp(cfg, gen, dtype, device)
        p[f"sub{j}"] = sub
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device="cuda") -> Params:
    """Fresh parameters: the reference's shapes, dtypes and scales,
    drawn from ``generator`` on its own device, one period at a time
    into the stacked ``[n_periods, ...]`` layout.  On ``"meta"`` nothing
    is drawn (``generator`` may be None)."""
    dtype = L.DTYPES[cfg.param_dtype]
    pl = period_len(cfg)
    assert cfg.n_layers % pl == 0, (cfg.n_layers, pl)
    return {
        "embed": L.dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                              dtype, scale=0.02, device=device),
        "periods": L.init_stacked(
            cfg.n_layers // pl,
            lambda: init_period(cfg, generator, dtype, device)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                dtype, device=device),
    }


def _period(p: Params, i: int) -> Params:
    return L.tree_map(lambda t: L.logical.gather_weight(t[i]), p["periods"])


def _ffn(cfg: ModelConfig, sub: Params, ffn: str,
         h: torch.Tensor) -> torch.Tensor:
    f = L.rmsnorm(h, sub["ffn_norm"], cfg.norm_eps)
    return h + L.ffn_block(cfg, sub[ffn], f, ffn == "moe")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _period_fwd(cfg: ModelConfig, pp: Params, h: torch.Tensor, *,
                positions: torch.Tensor, sparsity: float = 0.0):
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for j, (mixer, ffn) in enumerate(sublayer_kinds(cfg)):
        sub = pp[f"sub{j}"]
        x = L.rmsnorm(h, sub["mixer_norm"], cfg.norm_eps)
        if mixer == "attn":
            h = h + L.attn_block(cfg, sub["attn"], x, positions=positions,
                                 window=cfg.attn_window, sink=cfg.attn_sink,
                                 sparsity=sparsity)
        else:
            h = h + S.mamba_block(cfg, sub["mamba"], x)
        h = _ffn(cfg, sub, ffn, h)
        if ffn == "moe":
            aux = aux + L.moe_block.last_aux
    return h, aux


def forward(cfg: ModelConfig, p: Params, tokens: torch.Tensor, *,
            sparsity: float = 0.0, remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (hidden [B,S,D], moe_aux scalar).
    ``remat`` recomputes each period in the backward pass."""
    h = shard(L.embed_lookup(p["embed"], tokens), "batch", None, "embed")
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for pp in L.unstack(p["periods"], cfg.n_layers // period_len(cfg)):
        h, a = L.remat_call(
            remat, lambda hh, pp=pp: _period_fwd(
                cfg, pp, hh, positions=positions, sparsity=sparsity), h)
        aux = aux + a
    return h, aux


def _unembed(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(h, p["final_norm"], cfg.norm_eps)
    return shard(h @ p["lm_head"], "batch", None, "vocab")


def train_loss(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
               aux_weight: float = 0.01, remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy plus the MoE aux loss times
    ``aux_weight``; ``remat`` as the reference (on)."""
    from repro_torch.models.transformer import chunked_ce
    h, aux = forward(cfg, p, batch["tokens"], remat=remat)
    loss = chunked_ce(
        lambda hb: L.rmsnorm(hb, p["final_norm"], cfg.norm_eps) @ p["lm_head"],
        h, batch["targets"], batch.get("loss_mask"))
    return loss + aux_weight * aux


# ---------------------------------------------------------------------------
# serving: windowed ring-buffer KV for attention sublayers + mamba states
# ---------------------------------------------------------------------------

def cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    return kvcache.capacity(seq_len, cfg.attn_window, cfg.attn_sink)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda", like: Optional[torch.Tensor] = None
               ) -> Dict[str, Any]:
    """Zero caches per sublayer kind (under a mesh and with a DTensor
    ``like``, DTensors laid out by the serving rules' logical axes)."""
    n_periods = cfg.n_layers // period_len(cfg)
    cap = cache_capacity(cfg, max_len)
    kv_dtype = L.DTYPES[cfg.kv_dtype]
    di, h, hd, n = S.dims(cfg)
    conv_ch = di + 2 * S.N_GROUPS * cfg.ssm_state
    def zeros(shp, dtype, axes):
        if like is not None:
            return L.logical.empty(shp, dtype, like, axes).zero_()
        return torch.zeros(shp, dtype=dtype, device=device)

    cache: Dict[str, Any] = {}
    for j, (mixer, _) in enumerate(sublayer_kinds(cfg)):
        if mixer == "attn":
            shp = (n_periods, batch, cap, cfg.n_kv_heads, cfg.head_dim)
            kv = (None, "batch", "seq_kv", "kv_heads", None)
            cache[f"sub{j}"] = {"k": zeros(shp, kv_dtype, kv),
                                "v": zeros(shp, kv_dtype, kv)}
        else:
            cache[f"sub{j}"] = {
                "conv": zeros((n_periods, batch, cfg.ssm_conv - 1, conv_ch),
                              L.DTYPES[cfg.param_dtype],
                              (None, "batch", None, None)),
                "ssm": zeros((n_periods, batch, h, hd, n), torch.float32,
                             (None, "batch", "heads", None, None)),
            }
    return cache


def prefill(cfg: ModelConfig, p: Params, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, sparsity: float = 0.0, **_):
    """Returns (last-position logits, cache, cache_len [B])."""
    b, s = tokens.shape
    max_len = max_len or s
    cap = cache_capacity(cfg, max_len)
    sink, window = cfg.attn_sink, cfg.attn_window
    positions = torch.arange(s, device=tokens.device)
    h = L.embed_lookup(p["embed"], tokens)
    cache = init_cache(cfg, b, max_len, device=h.device, like=h)
    for i in range(cfg.n_layers // period_len(cfg)):
        pp = _period(p, i)
        for j, (mixer, ffn) in enumerate(sublayer_kinds(cfg)):
            sub, subc = pp[f"sub{j}"], cache[f"sub{j}"]
            x = L.rmsnorm(h, sub["mixer_norm"], cfg.norm_eps)
            if mixer == "attn":
                q, k, v = L.attn_qkv(cfg, sub["attn"], x, positions)
                o = mha(q, k, v, n_kv_heads=cfg.n_kv_heads, causal=True,
                        window=window, sink=sink, sparsity=sparsity)
                o = o.reshape(b, s, cfg.n_heads * cfg.head_dim)
                h = h + o @ sub["attn"]["wo"]
                for name, t in (("k", k), ("v", v)):
                    kvcache.write_cast(subc[name][i], kvcache.place_prefill(
                        t, cap, sink, window))
            else:
                out, (conv_s, ssm_s) = S.mamba_block(
                    cfg, sub["mamba"], x, return_state=True)
                h = h + out
                kvcache.write_cast(subc["conv"][i], conv_s)
                kvcache.write_cast(subc["ssm"][i], ssm_s)
            h = _ffn(cfg, sub, ffn, h)
    logits = _unembed(cfg, p, h[:, -1:])[:, 0]
    return logits, cache, torch.full((b,), s, dtype=torch.int32,
                                     device=h.device)


def decode_step(cfg: ModelConfig, p: Params, cache: Dict[str, Any],
                token: torch.Tensor, pos: torch.Tensor, **_):
    """One decode step with ring-buffer windowed attention caches.

    Returns (logits [B,V], cache): the attention sublayers' new K/V and
    the Mamba sublayers' new conv / SSM states are written into the
    given cache IN PLACE and the same tensors are returned (the
    reference returns an updated copy; see ``transformer.decode_step``).
    """
    b = token.shape[0]
    sink, window = cfg.attn_sink, cfg.attn_window
    h = L.embed_lookup(p["embed"], token)
    positions = pos[:, None]
    for i in range(cfg.n_layers // period_len(cfg)):
        pp = _period(p, i)
        for j, (mixer, ffn) in enumerate(sublayer_kinds(cfg)):
            sub, subc = pp[f"sub{j}"], cache[f"sub{j}"]
            x = L.rmsnorm(h, sub["mixer_norm"], cfg.norm_eps)
            if mixer == "attn":
                q, k, v = L.attn_qkv(cfg, sub["attn"], x, positions)
                cap = subc["k"].shape[2]
                ring_mode = bool(window) and cap == sink + window
                dest = kvcache.ring_dest(pos, cap, sink) if ring_mode else pos
                kc = kvcache.write_token(subc["k"][i], k, dest)
                vc = kvcache.write_token(subc["v"][i], v, dest)
                o = decode_attention(q, kc, vc, n_kv_heads=cfg.n_kv_heads,
                                     cache_len=kvcache.n_valid(pos, cap),
                                     window=0 if ring_mode else window,
                                     sink=sink)
                o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim)
                h = h + o @ sub["attn"]["wo"]
            else:
                out, (c2, s2) = S.mamba_decode(cfg, sub["mamba"], x,
                                               subc["conv"][i],
                                               subc["ssm"][i])
                h = h + out
                kvcache.write_cast(subc["conv"][i], c2)
                kvcache.write_cast(subc["ssm"][i], s2)
            h = _ffn(cfg, sub, ffn, h)
    return _unembed(cfg, p, h)[:, 0], cache
