"""Shared layer substrate: param-tree helpers, norms, RoPE, the
attention block, MLP and MoE (forward).

Params are nested dicts of tensors; every apply fn takes the config +
params explicitly, like the JAX reference.  Stacked-layer params keep
their leading ``[L, ...]`` axis and the model code loops over it.  The
init helpers take the target ``device``; on ``"meta"`` they draw
nothing and return meta tensors of the same shapes and dtypes
(``configs.base.param_count``, ``registry.param_specs``).

The reference's ``shard(...)`` annotations stand at its own places
(``distributed.logical.shard``): no-ops outside a mesh; under one they
redistribute the DTensors of a sharded step.  There a layer's weights
are all-gathered over the FSDP axes as the layer is taken from the
stack (``layer_params`` / ``unstack``), and the MoE's routing, dispatch
and combine run on each batch shard's local tensors (DTensor has no
rule for their gathers and scatters).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import logical
from repro_torch.distributed.logical import shard
from repro_torch.models.attention import mha

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float8_e4m3fn": torch.float8_e4m3fn}


# ---------------------------------------------------------------------------
# param trees
# ---------------------------------------------------------------------------

def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_stacked(n: int, make) -> Params:
    """``n`` trees from ``make()`` stacked into ``[n, ...]`` tensors,
    copied in one tree at a time into tensors allocated once (the peak
    is the stack plus one tree, not twice the stack)."""
    def copy_into(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                copy_into(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    first = make()
    if n == 1:                     # a view: nothing allocated twice
        return tree_map(lambda t: t.unsqueeze(0), first)
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        copy_into(out, first if i == 0 else make(), i)
    return out


def layer_params(p: Params, i: int) -> Params:
    """Layer ``i``'s view of the stacked ``[L, ...]`` layer params
    (under a mesh, all-gathered over the FSDP axes)."""
    return tree_map(lambda t: logical.gather_weight(t[i]), p["layers"])


class _Layers:
    """The per-layer views of ``unstack``, each all-gathered over the
    FSDP axes when it is taken (one layer's weights at a time)."""

    def __init__(self, views: Params, n: int):
        self.views, self.n = views, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Params:
        if not -self.n <= i < self.n:
            raise IndexError(i)
        return tree_map(lambda ts: logical.gather_weight(ts[i]), self.views)


def unstack(stack: Params, n: int) -> _Layers:
    """The ``n`` per-layer views of stacked ``[n, ...]`` params, one
    ``unbind`` per leaf: autograd then stacks the layers' gradients once,
    where ``n`` ``t[i]`` selects would each scatter one layer's gradient
    into a zero tensor of the whole stack and sum ``n`` such stacks."""
    return _Layers(tree_map(lambda t: t.unbind(0), stack), n)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On DTensors, each batch shard's tokens are
    looked up in the table's local block of rows (the vocab stays split
    over the mesh dims that split it; the rest of the table is gathered
    as ``logical.gather_weight`` gathers a layer's weight): rows outside
    the block give 0, and the partial rows are summed over the vocab
    dims (an all-reduce of the activations, as GSPMD does for the
    reference's ``take``; the table is never gathered whole).  The
    gather and its backward's accumulating ``index_put`` run on the
    local tensors, where DTensor's own rule for that ``index_put``
    fails on some torch versions."""
    if not isinstance(table, logical.DTensor):
        return table[tokens.long()]
    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 and k > 1
             for p, k in zip(table.placements, mesh.shape)]
    rows = logical.batch_split(mesh, tokens.shape[0], vocab)
    t_pl = tuple(Shard(0) if v else Replicate() for v in vocab)
    table = table.redistribute(mesh, t_pl) \
        if tuple(table.placements) != t_pl else table
    tok_pl = tuple(Shard(0) if r else Replicate() for r in rows)
    tok = logical.as_dtensor(tokens, mesh)
    tok = tok.redistribute(mesh, tok_pl).to_local()
    # a table replicated over a dim that splits the rows gets a partial
    # gradient from each row shard, summed over the dim
    t_l = table.to_local(grad_placements=[
        Partial() if r else p for r, p in zip(rows, t_pl)])
    off, n = logical.local_box(table.shape, mesh, t_pl)
    idx = tok.long() - off[0]
    hit = (idx >= 0) & (idx < n[0])
    out = torch.where(hit[..., None], t_l[torch.clamp(idx, 0, n[0] - 1)],
                      torch.zeros((), dtype=t_l.dtype, device=t_l.device))
    part = [Shard(0) if r else Partial() if v else Replicate()
            for r, v in zip(rows, vocab)]
    return logical.DTensor.from_local(out, mesh, part, run_check=False) \
        .redistribute(mesh, tok_pl)


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` under activation checkpointing
    (``torch.utils.checkpoint``, non-reentrant: tensors ``fn`` closes
    over, such as a layer's parameter views, get their gradients too),
    the reference's ``jax.checkpoint`` of a scanned layer body.  The
    recomputation re-enters the mesh context of the forward (autograd
    may run it on another thread)."""
    if not remat:
        return fn(*args)
    env = logical.current()
    if env is not None:
        inner = fn

        def fn(*a):
            with logical.use_env(env):
                return inner(*a)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def is_meta(device) -> bool:
    return torch.device(device).type == "meta"


def dense_init(gen: Optional[torch.Generator], shape, dtype,
               scale: Optional[float] = None,
               device="cpu") -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in), drawn in float32 from
    ``gen`` on the generator's own device (so the values do not depend
    on the target device), cast to ``dtype`` and moved to ``device``.
    On ``device="meta"`` nothing is drawn and ``gen`` may be None."""
    if is_meta(device):
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype).to(device)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [B,S,H,D]; positions: [S] or [B,S] (absolute)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = positions.to(torch.float32)
    if positions.ndim == 1:
        ang = pos[None, :, None] * freqs                  # [1,S,half]
    else:
        ang = pos[:, :, None] * freqs                     # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention projections
# ---------------------------------------------------------------------------

def init_attn(cfg: ModelConfig, gen: torch.Generator, dtype,
              device="cpu") -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, hq * dh), dtype, device=device),
        "wk": dense_init(gen, (d, hkv * dh), dtype, device=device),
        "wv": dense_init(gen, (d, hkv * dh), dtype, device=device),
        "wo": dense_init(gen, (hq * dh, d), dtype, device=device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def attn_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
             positions: torch.Tensor):
    """Project + RoPE.  Returns q [B,S,Hq,Dh], k,v [B,S,Hkv,Dh]."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = logical.whole_heads(q, 2, hq).reshape(b, s, hq, dh)
    k = logical.whole_heads(k, 2, hkv).reshape(b, s, hkv, dh)
    v = logical.whole_heads(v, 2, hkv).reshape(b, s, hkv, dh)
    # all three are contiguous (RoPE writes fresh tensors, v is a view of
    # a fresh product), as the flash kernel's wrapper requires: no copy
    q = shard(rope(q, positions, cfg.rope_theta), "batch", None, "heads", None)
    k = shard(rope(k, positions, cfg.rope_theta), "batch", None, "kv_heads",
              None)
    return q, k, v


def attn_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
               positions: torch.Tensor, q_offset: int = 0,
               window: int = 0, sink: int = 0, sparsity: float = 0.0,
               kv_override=None, causal: bool = True,
               block_q: int = 512, block_kv: int = 512) -> torch.Tensor:
    """Self-attention (or cross-attention via kv_override=(k,v)) through
    ``attention.mha``: the flash kernel on the card."""
    b, s, _ = x.shape
    q, k, v = attn_qkv(cfg, p, x, positions)
    if kv_override is not None:
        k, v = kv_override
    o = mha(q, k, v, n_kv_heads=cfg.n_kv_heads, causal=causal,
            q_offset=q_offset, window=window, sink=sink, sparsity=sparsity,
            block_q=block_q, block_kv=block_kv)
    o = o.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return shard(o @ p["wo"], "batch", "seq_sp", "embed")


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype,
             device="cpu") -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {"w_gate": dense_init(gen, (d, f), dtype, device=device),
                "w_up": dense_init(gen, (d, f), dtype, device=device),
                "w_down": dense_init(gen, (f, d), dtype, device=device)}
    return {"wi": dense_init(gen, (d, f), dtype, device=device),
            "wo": dense_init(gen, (f, d), dtype, device=device)}


def mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        h = shard(h, "batch", None, "ff")
        return shard(h @ p["w_down"], "batch", "seq_sp", "embed")
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["wi"], approximate="tanh")
    h = shard(h, "batch", None, "ff")
    return shard(h @ p["wo"], "batch", "seq_sp", "embed")


# ---------------------------------------------------------------------------
# MoE: token-choice top-k with per-sequence capacity (forward)
# ---------------------------------------------------------------------------
#
# The reference dispatches with a scatter-add into the expert slots and
# combines with a scatter-add back to tokens (``_slot_scatter_to_tokens``,
# which also serves its dispatch's custom backward).  Here the dispatch
# gathers each slot's token through the slot map (``_slot_maps``: a pure
# copy, bit-identical to the reference's ``x * 1`` adds), and the combine
# gathers each token's k assignments and adds them one at a time in
# ascending expert order -- the order in which the reference's scatter
# adds a token's slots -- so neither uses atomics and both are
# deterministic on the card.  Autograd through the dispatch gather sums
# each slot's gradient back into its token: the function of the
# reference's custom backward (``_moe_dispatch_bwd``, a slot scatter to
# tokens), routing and capacity masks constant; no custom Function is
# needed (the CPU tests hold the gradients to JAX's at 1e-5).

def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype,
             device="cpu") -> Params:
    d, fe, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        # the router stays fp32 in every model dtype, as in the reference
        "router": dense_init(gen, (d, e), torch.float32, device=device),
        "we_gate": dense_init(gen, (e, d, fe), dtype, device=device),
        "we_up": dense_init(gen, (e, d, fe), dtype, device=device),
        "we_down": dense_init(gen, (e, fe, d), dtype, device=device),
    }


def moe_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    return max(1, int(math.ceil(
        tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def moe_route(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """Router of ``moe_block``.  x [B,S,D] -> (probs [B,S,E] fp32, top-k
    experts [B,S,k], their renormalised gates [B,S,k] fp32, slot [B,S*k]
    of each assignment in its expert's queue).  Assignments are numbered
    token-major (``s * k + j``) and an expert's slots are handed out in
    that order (``cumsum(one_hot) - 1``), so the capacity drops are the
    reference's."""
    e, k = cfg.n_experts, cfg.top_k
    b, s, _ = x.shape
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    a_e = idx.reshape(b, s * k)
    # the one-hot laid out [B,E,S*k], so the cumsum runs along the
    # innermost axis (along a middle one it is a slow strided scan)
    oh = (a_e[:, None, :] == torch.arange(e, device=x.device)[None, :, None])
    slot = torch.gather(torch.cumsum(oh, dim=2, dtype=torch.int32) - 1, 1,
                        a_e[:, None, :])
    return probs, idx, gate_vals, slot[:, 0]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean one-hot of ``idx`` over ``n`` classes (``F.one_hot``
    validates its indices on the host, a device sync per call)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _slot_maps(e: int, cap: int, s: int, a_e: torch.Tensor,
               slot: torch.Tensor, k: int) -> torch.Tensor:
    """Token of each (e, c) slot, [B,E,cap] (``s`` where the slot is
    empty).  Assignments past capacity go to a spare column ``cap`` that
    is sliced off (the reference's ``mode="drop"``); only that column
    takes more than one write."""
    b = a_e.shape[0]
    tok_of = torch.full((b, e, cap + 1), s, dtype=torch.long,
                        device=a_e.device)
    a_t = torch.arange(s * k, device=a_e.device) // k         # token of asgn
    rows = torch.arange(b, device=a_e.device)[:, None]
    tok_of[rows, a_e, torch.clamp(slot, max=cap)] = a_t.expand(b, -1)
    return tok_of[..., :cap]


def _moe_dispatch(x: torch.Tensor, tok_of: torch.Tensor) -> torch.Tensor:
    """Token -> slot dispatch [B,S,D] -> [B,E,cap,D]: each slot's token
    row, zeros in empty slots."""
    b = x.shape[0]
    x_pad = torch.cat([x, x.new_zeros((b, 1, x.shape[2]))], dim=1)
    rows = torch.arange(b, device=x.device)[:, None, None]
    return x_pad[rows, tok_of]


def _moe_combine(out_buf: torch.Tensor, a_e: torch.Tensor,
                 slot: torch.Tensor, gates: torch.Tensor, cap: int,
                 k: int) -> torch.Tensor:
    """Slot -> token combine [B,E,cap,D] -> [B,S,D]: the sum over each
    token's kept assignments of its expert's output times its gate,
    added one at a time in ascending expert order in ``out_buf``'s dtype
    (the reference's scatter-add order).  Dropped assignments add a
    zero row."""
    b, e, _, d = out_buf.shape
    s = a_e.shape[1] // k
    kept = slot < cap
    flat = torch.where(kept, a_e * cap + slot, e * cap).view(b, s, k)
    w = torch.where(kept, gates.reshape(b, s * k), 0.0).view(b, s, k)
    order = torch.argsort(a_e.view(b, s, k), dim=-1)
    flat = torch.gather(flat, 2, order)
    w = torch.gather(w, 2, order).to(out_buf.dtype)
    src = torch.cat([out_buf.reshape(b, e * cap, d),
                     out_buf.new_zeros((b, 1, d))], dim=1)
    rows = torch.arange(b, device=out_buf.device)[:, None]
    y = src[rows, flat[..., 0]] * w[..., 0, None]
    for j in range(1, k):
        y = y + src[rows, flat[..., j]] * w[..., j, None]
    return y


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Token-choice top-k MoE with per-sequence grouping.

    x: [B,S,D] -> [B,S,D]; the Switch-style load-balancing aux loss is
    kept in ``moe_block.last_aux``, as in the reference (serving ignores
    it)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(s, cfg)

    def route(x, router):
        probs, idx, gate_vals, slot = moe_route(cfg, {"router": router}, x)
        a_e = idx.reshape(x.shape[0], s * k)
        buf = _moe_dispatch(x, _slot_maps(e, cap, s, a_e, slot, k))
        return probs, idx, gate_vals, slot, buf

    def combine(out_buf, idx, slot, gate_vals):
        return _moe_combine(out_buf, idx.reshape(idx.shape[0], s * k), slot,
                            gate_vals, cap, k)

    by_row = (0, None)
    probs, idx, gate_vals, slot, buf = per_batch_shard(
        route, (x, p["router"]), (by_row, (None, None)), (by_row,) * 5)
    me = torch.mean(probs, dim=(0, 1))                         # [E]
    ce = torch.mean(_one_hot(idx, e).float(), dim=(0, 1, 2))
    moe_block.last_aux = e * torch.sum(me * ce)

    # expert-TP (default): dispatch buffer replicated over "model", the
    # expert hidden dim sharded.  EP (cfg.moe_ep): the EXPERT dim sharded
    # over "model".
    buf = shard(buf, "batch", "experts", None, None)
    hg = torch.einsum("becd,edf->becf", buf, p["we_gate"])
    hu = torch.einsum("becd,edf->becf", buf, p["we_up"])
    h = shard(F.silu(hg) * hu, "batch", "experts", None, "expert_ff")
    out_buf = torch.einsum("becf,efd->becd", h, p["we_down"])
    out_buf = shard(out_buf, "batch", "experts", None, "embed")
    y = per_batch_shard(combine, (out_buf, idx, slot, gate_vals),
                         (by_row,) * 4, by_row)
    return shard(y, "batch", "seq_sp", "embed")


def per_batch_shard(fn, args, dims, out_dims):
    """``fn(*args)``; on DTensors, on each batch shard's local tensors
    (``logical.per_shard``), every other dim replicated."""
    if not isinstance(args[0], logical.DTensor):
        return fn(*args)
    return logical.per_shard(fn, args, dims, out_dims,
                             batch=args[0].shape[0], heads=())


moe_block.last_aux = 0.0


def ffn_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
              use_moe: bool) -> torch.Tensor:
    return moe_block(cfg, p, x) if use_moe else mlp_block(cfg, p, x)
