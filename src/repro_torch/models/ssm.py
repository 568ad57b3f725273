"""Mamba-2 (SSD) model: block init/apply and the serving surface
(prefill / decode), a port of the JAX reference's ``models/ssm.py``.
Attention-free; per-token decode is an O(1) state update.

Block layout follows Mamba-2 (arXiv:2405.21060): separate projections per
component (z, x, B, C, dt); depthwise causal conv over (x,B,C); SSD scan
(``kernels/ssd_scan``: the CUDA kernel on the card, the plain version on
the CPU); gated RMSNorm; out projection.  The stacked ``[L, ...]`` layer
parameters are consumed by a Python loop (the reference's ``lax.scan``);
the reference's ``shard`` annotations are identity on one device and are
dropped.  ``train_loss`` trains through the plain SSD on the CPU; on the
card the SSD kernel has no backward yet, so its wrapper raises under
grad (as ``ssd_pallas``, which has no VJP, fails on the TPU).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.logical import shard
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers as L

Params = Dict[str, Any]

N_GROUPS = 1


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_ssm_heads, head_dim, state)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_head_dim
    assert d_inner % hd == 0, (d_inner, hd)
    return d_inner, d_inner // hd, hd, cfg.ssm_state


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------

def init_mamba(cfg: ModelConfig, gen: torch.Generator, dtype,
               device="cpu") -> Params:
    d = cfg.d_model
    di, h, hd, n = dims(cfg)
    g = N_GROUPS
    f32 = torch.float32
    if L.is_meta(device):
        dt_bias = torch.empty((h,), dtype=f32, device="meta")
    else:
        # dt bias: init so softplus(dt_bias) spans [1e-3, 1e-1] (Mamba-2
        # default), drawn on the generator's device
        u = torch.rand((h,), generator=gen, dtype=f32, device=gen.device)
        dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                            + math.log(1e-3))
        dt_bias = (dt_init + torch.log(-torch.expm1(-dt_init))).to(device)
    conv_ch = di + 2 * g * n
    return {
        "wz": L.dense_init(gen, (d, di), dtype, device=device),
        "wx": L.dense_init(gen, (d, di), dtype, device=device),
        "wB": L.dense_init(gen, (d, g * n), dtype, device=device),
        "wC": L.dense_init(gen, (d, g * n), dtype, device=device),
        "wdt": L.dense_init(gen, (d, h), dtype, device=device),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.arange(1, h + 1, dtype=f32, device=device)),
        "D": torch.ones((h,), dtype=f32, device=device),
        "conv_w": L.dense_init(gen, (conv_ch, cfg.ssm_conv), dtype,
                               scale=1.0 / math.sqrt(cfg.ssm_conv),
                               device=device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "norm_w": torch.ones((di,), dtype=dtype, device=device),
        "out": L.dense_init(gen, (di, d), dtype, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x [B,S,C], w [C,K], prev [B,K-1,C] or None.
    The taps multiply x by the fp32 weights, so the sum, the bias and
    the silu are fp32; the result is cast back to x's dtype."""
    k = w.shape[1]
    if prev is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([prev.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[None, None, :, i].float() for i in range(k))
    return F.silu(out + b.float()).to(x.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
    return L.rmsnorm(y * F.silu(z.float()).to(y.dtype), w, eps)


def _dt(p: Params, x: torch.Tensor) -> torch.Tensor:
    """softplus of the fp32 dt projection plus bias.  torch's softplus
    returns its input above 20 where JAX's is ``logaddexp(x, 0)``; the
    two differ by log1p(exp(-x)) < 2.1e-9 there, below an fp32 ulp."""
    return F.softplus((x @ p["wdt"]).float() + p["dt_bias"])


def mamba_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Full-sequence Mamba-2 block.  x [B,S,D] -> [B,S,D].

    With ``return_state``, also returns (conv_state [B,K-1,C],
    ssm_state [B,H,P,N]) after the last position: the conv state is the
    last K-1 rows of the pre-conv (x,B,C), in the model dtype.
    """
    b, s, _ = x.shape
    di, h, hd, n = dims(cfg)
    g = N_GROUPS
    z = shard(x @ p["wz"], "batch", None, "inner")
    xi = shard(x @ p["wx"], "batch", None, "inner")
    Bp = x @ p["wB"]
    Cp = x @ p["wC"]
    dt = _dt(p, x)                                            # [B,S,H]

    def conv(xi, Bp, Cp, w, bias, conv_state):
        xbc = torch.cat([xi, Bp, Cp], dim=-1)
        # a copy, so the state does not keep the whole [B,S,C] alive
        state = (xbc[:, -(cfg.ssm_conv - 1):, :].clone(),) \
            if return_state else ()
        xbc = _causal_conv(xbc, w, bias, conv_state)
        return torch.split(xbc, [di, g * n, g * n], dim=-1) + state

    # per batch shard under a mesh (the conv's pad, shifted slices and
    # split have no usable DTensor rules on every torch version)
    by_row = (0, None)
    xi, Bp, Cp, *new_conv_state = L.per_batch_shard(
        conv, (xi, Bp, Cp, p["conv_w"], p["conv_b"], conv_state),
        (by_row,) * 3 + ((None, None),) * 2 + (by_row,),
        (by_row,) * (4 if return_state else 3))
    new_conv_state = new_conv_state[0] if return_state else None

    A = -torch.exp(p["A_log"])
    xh = xi.reshape(b, s, h, hd)          # a strided view of the conv output
    y, final_state = ssd_ops.ssd(
        xh, dt, A, Bp.reshape(b, s, g, n), Cp.reshape(b, s, g, n),
        chunk=cfg.ssm_chunk, init_state=ssm_state)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    y = _gated_norm(y.reshape(b, s, di), z, p["norm_w"], cfg.norm_eps)
    out = shard(y @ p["out"], "batch", None, "embed")
    if return_state:
        return out, (new_conv_state, final_state)
    return out


def mamba_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One-token step.  x [B,1,D]; states as produced by mamba_block.

    Returns (out [B,1,D], (conv_state, ssm_state)).
    """
    b = x.shape[0]
    di, h, hd, n = dims(cfg)
    g = N_GROUPS
    z = x @ p["wz"]
    xi = x @ p["wx"]
    Bp = x @ p["wB"]
    Cp = x @ p["wC"]
    dt = _dt(p, x)[:, 0]                                      # [B,H]

    def conv(xi, Bp, Cp, w, bias, conv_state):
        xbc = torch.cat([xi, Bp, Cp], dim=-1)                 # [B,1,C]
        window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        out = torch.einsum("bkc,ck->bc", window.float(), w.float())
        xbc = F.silu(out + bias.float())
        xbc = xbc.to(x.dtype)[:, None, :]
        return torch.split(xbc, [di, g * n, g * n], dim=-1) + (window[:, 1:],)

    by_row = (0, None)
    xi, Bp, Cp, new_conv_state = L.per_batch_shard(
        conv, (xi, Bp, Cp, p["conv_w"], p["conv_b"], conv_state),
        (by_row,) * 3 + ((None, None),) * 2 + (by_row,), (by_row,) * 4)

    A = -torch.exp(p["A_log"])
    y, new_ssm = ssd_ops.ssd_decode(
        xi.reshape(b, h, hd), dt, A,
        Bp.reshape(b, g, n), Cp.reshape(b, g, n), ssm_state)
    y = y + xi.reshape(b, h, hd) * p["D"].to(y.dtype)[None, :, None]
    y = _gated_norm(y.reshape(b, 1, di), z, p["norm_w"], cfg.norm_eps)
    return y @ p["out"], (new_conv_state, new_ssm)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def init_layer(cfg: ModelConfig, gen: torch.Generator, dtype,
               device="cpu") -> Params:
    return {
        "norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mamba": init_mamba(cfg, gen, dtype, device),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device="cuda") -> Params:
    """Fresh parameters: the reference's shapes and scales, drawn from
    ``generator`` on its own device (values do not depend on the target
    device) one layer at a time into the stacked ``[L, ...]`` layout.
    On ``"meta"`` nothing is drawn (``generator`` may be None)."""
    dtype = L.DTYPES[cfg.param_dtype]
    return {
        "embed": L.dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                              dtype, scale=0.02, device=device),
        "layers": L.init_stacked(
            cfg.n_layers, lambda: init_layer(cfg, generator, dtype, device)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }


def _embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return shard(L.embed_lookup(p["embed"], tokens), "batch", None, "embed")


def forward(cfg: ModelConfig, p: Params, tokens: torch.Tensor, *,
            remat: bool = False) -> torch.Tensor:
    """tokens [B,S] -> final hidden states [B,S,D] (before the norm).
    ``remat`` recomputes each layer in the backward pass."""
    h = _embed(p, tokens)
    for lp in L.unstack(p["layers"], cfg.n_layers):

        def body(hh, lp=lp):
            x = L.rmsnorm(hh, lp["norm"], cfg.norm_eps)
            return hh + mamba_block(cfg, lp["mamba"], x)

        h = L.remat_call(remat, body, h)
    return h


def _unembed(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(h, p["final_norm"], cfg.norm_eps)
    return shard(h @ p["embed"].T, "batch", None, "vocab")


def train_loss(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
               remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy, tied embeddings; ``remat`` as the
    reference (on)."""
    from repro_torch.models.transformer import chunked_ce
    h = forward(cfg, p, batch["tokens"], remat=remat)
    return chunked_ce(
        lambda hb: L.rmsnorm(hb, p["final_norm"], cfg.norm_eps) @ p["embed"].T,
        h, batch["targets"], batch.get("loss_mask"))


def init_state(cfg: ModelConfig, batch: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    di, h, hd, n = dims(cfg)
    conv_ch = di + 2 * N_GROUPS * cfg.ssm_state
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=L.DTYPES[cfg.param_dtype], device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, h, hd, n),
                           dtype=torch.float32, device=device),
    }


def prefill(cfg: ModelConfig, p: Params, tokens: torch.Tensor, **_):
    """Returns (last-position logits [B,V], state, cache_len [B])."""
    b, s = tokens.shape
    h = _embed(p, tokens)
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        lp = L.layer_params(p, i)
        x = L.rmsnorm(h, lp["norm"], cfg.norm_eps)
        out, (conv_s, ssm_s) = mamba_block(cfg, lp["mamba"], x,
                                           return_state=True)
        h = h + out
        convs.append(conv_s)
        ssms.append(ssm_s)
    logits = _unembed(cfg, p, h[:, -1:])[:, 0]
    state = {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}
    return logits, state, torch.full((b,), s, dtype=torch.int32,
                                     device=tokens.device)


def decode_step(cfg: ModelConfig, p: Params, state: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: torch.Tensor, **_):
    """One decode step.  token [B,1].  Returns (logits [B,V], state); the
    new state is fresh tensors, the given one is left as it was."""
    h = _embed(p, token)
    conv = torch.empty_like(state["conv"])
    ssm = torch.empty_like(state["ssm"])
    for i in range(cfg.n_layers):
        lp = L.layer_params(p, i)
        x = L.rmsnorm(h, lp["norm"], cfg.norm_eps)
        out, (conv_s, ssm_s) = mamba_decode(
            cfg, lp["mamba"], x, state["conv"][i], state["ssm"][i])
        conv[i] = conv_s
        ssm[i] = ssm_s
        h = h + out
    return _unembed(cfg, p, h)[:, 0], {"conv": conv, "ssm": ssm}
