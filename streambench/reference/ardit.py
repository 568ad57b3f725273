"""Plain float32 reference of the AR-DiT chunk generation the benchmark serves.

One stream at a time, written from the model's equations with plain torch
operations: no kernel, no page pool, no batching.  It imports nothing of the
program.  Matrix products run in float32 with TF32 off (``strict_fp32``).

What it works out again, for every chunk of a stream the program served:

* the sink: the conditioning tokens projected to every layer's K and V;
* the visible context of the chunk: the sink plus the last
  ``min(W, chunks so far, W_max)`` chunks, thinned by the rho block keep
  list on denoise passes and whole on the clean pass;
* the sigma grid of S Euler steps from the noise, then one clean pass at
  t = 0 whose K and V are stored rounded as the configuration stores them
  (bfloat16 pages; float8 e4m3 first where the fidelity says fp8).

``replay`` is teacher-forced: the clean pass of chunk k reads the chunk the
program served, so each chunk is judged on the context that the program's
own earlier chunks give.  Chunk order, the sink and the KV written to and
read back from the pool all enter the comparison that way.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# |x| above this becomes NaN when cast to float8 e4m3 (the configuration's
# overflow rule; torch's own cast saturates at 448)
E4M3_NAN_ABOVE = 464.0


def strict_fp32() -> None:
    """float32 matrix products without TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def parse_key(key: str) -> Dict[str, object]:
    """A fidelity key ``S4_r0.6_W7_bf16`` (optionally ``_c<x>``) ->
    steps, sparsity, window, quant."""
    parts = key.split("_")
    return {"steps": int(parts[0][1:]), "sparsity": float(parts[1][1:]),
            "window": int(parts[2][1:]), "quant": parts[3]}


def chunk_tokens(cfg: Dict) -> int:
    return cfg["ardit_chunk_frames"] * cfg["ardit_frame_tokens"]


def sigma_grid(steps: int) -> np.ndarray:
    """Rectified-flow time grid from 1 (noise) to 0 (data)."""
    return np.linspace(1.0, 0.0, steps + 1)


def keep_blocks(n_blocks: int, sparsity: float) -> List[int]:
    """rho block keep list over ``n_blocks`` context blocks: the first and
    the last block always, a strided ~(1 - rho) share of the rest."""
    frac = max(1e-6, 1.0 - sparsity)
    forced = set(range(min(1, n_blocks))) | {n_blocks - 1}
    middle = [j for j in range(n_blocks) if j not in forced]
    n_keep = int(round(len(middle) * frac))
    if n_keep >= len(middle):
        chosen = middle
    elif n_keep <= 0:
        chosen = []
    else:
        idx = np.linspace(0, len(middle) - 1, n_keep).round().astype(int)
        chosen = [middle[j] for j in sorted(set(idx.tolist()))]
    return sorted(forced | set(chosen))


def visible_index(cfg: Dict, n_ctx_chunks: int,
                  sparsity: float) -> np.ndarray:
    """Indices of the visible tokens of a context laid out as the sink
    followed by ``n_ctx_chunks`` chunks in order: all of them without
    sparsity; under rho the sink, the kept 128-token blocks and the tail."""
    sink = cfg["cond_tokens"]
    ctx_len = sink + n_ctx_chunks * chunk_tokens(cfg)
    if sparsity <= 0.0 or ctx_len <= sink:
        return np.arange(ctx_len)
    blk = 128
    n_blocks = max(1, (ctx_len - sink) // blk)
    idx = [np.arange(sink)]
    for j in keep_blocks(n_blocks, sparsity):
        idx.append(np.arange(sink + j * blk,
                             min(sink + (j + 1) * blk, ctx_len)))
    tail = sink + n_blocks * blk
    if tail < ctx_len:
        idx.append(np.arange(tail, ctx_len))
    return np.unique(np.concatenate(idx))


def store_kv(x: torch.Tensor, quant: str, kv_dtype: str) -> torch.Tensor:
    """KV as the pool stores it, back in float32: through float8 e4m3 when
    the fidelity says fp8 (NaN above 464), then in the pool's dtype."""
    if quant == "fp8":
        bad = ~(x.abs() <= E4M3_NAN_ABOVE)
        x = torch.where(bad, torch.nan, x).to(torch.float8_e4m3fn).float()
    return x.to(getattr(torch, kv_dtype)).float()


class Weights:
    """The benchmark's weights, read one layer at a time in float32."""

    def __init__(self, params: Dict, n_layers: int):
        self.p = params
        self.n_layers = n_layers
        self._top = {k: params[k].float() for k in
                     ("in_proj", "cond_proj", "t_mlp1", "t_mlp2",
                      "final_norm", "final_mod", "out_proj")}
        self._layers: Dict[int, Dict[str, torch.Tensor]] = {}

    def top(self, name: str) -> torch.Tensor:
        return self._top[name]

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        if i not in self._layers:
            self._layers[i] = self._convert(i)
        return self._layers[i]

    def _convert(self, i: int) -> Dict[str, torch.Tensor]:
        lp = self.p["layers"]
        return {"wq": lp["attn"]["wq"][i].float(),
                "wk": lp["attn"]["wk"][i].float(),
                "wv": lp["attn"]["wv"][i].float(),
                "wo": lp["attn"]["wo"][i].float(),
                "wi": lp["mlp"]["wi"][i].float(),
                "wm": lp["mlp"]["wo"][i].float(),
                "mod": lp["mod"][i].float(),
                "mod_b": lp["mod_b"][i].float()}


def rmsnorm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, halves rotated: x [S, H, D], pos [S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None, None] * freqs
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def time_embed(w: Weights, t: float, device) -> torch.Tensor:
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(128, dtype=torch.float32,
                                     device=device) / 128)
    ang = torch.tensor(t, dtype=torch.float32, device=device) * freqs * 1000.0
    emb = torch.cat([torch.cos(ang), torch.sin(ang)])
    return F.silu(emb @ w.top("t_mlp1")) @ w.top("t_mlp2")


def qkv(cfg: Dict, lw: Dict, x: torch.Tensor, pos: torch.Tensor):
    s = x.shape[0]
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    q = rope((x @ lw["wq"]).view(s, hq, dh), pos, cfg["rope_theta"])
    k = rope((x @ lw["wk"]).view(s, hkv, dh), pos, cfg["rope_theta"])
    v = (x @ lw["wv"]).view(s, hkv, dh)
    return q, k, v


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_block: int = 1024) -> torch.Tensor:
    """Softmax attention of q [Sq, Hq, D] over k, v [Sk, Hkv, D], every key
    visible, in blocks of queries so that the scores fit."""
    hq, hkv = q.shape[1], k.shape[1]
    k = k.repeat_interleave(hq // hkv, dim=1).permute(1, 2, 0)   # [H,D,Sk]
    v = v.repeat_interleave(hq // hkv, dim=1).transpose(0, 1)    # [H,Sk,D]
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = []
    for lo in range(0, q.shape[0], q_block):
        qb = q[lo:lo + q_block].transpose(0, 1)                   # [H,b,D]
        p = torch.softmax(torch.bmm(qb, k) * scale, dim=-1)
        out.append(torch.bmm(p, v).transpose(0, 1))
    return torch.cat(out).reshape(q.shape[0], -1)


def sink_kv(cfg: Dict, w: Weights, cond: torch.Tensor):
    """Per-layer K, V of the conditioning tokens, stored (no fp8)."""
    c = cond.float().reshape(cfg["cond_tokens"], -1) @ w.top("cond_proj")
    pos = torch.arange(cfg["cond_tokens"], device=c.device)
    ks, vs = [], []
    for i in range(cfg["n_layers"]):
        _, k, v = qkv(cfg, w.layer(i), c, pos)
        ks.append(store_kv(k, "bf16", cfg["kv_dtype"]))
        vs.append(store_kv(v, "bf16", cfg["kv_dtype"]))
    return ks, vs


def forward(cfg: Dict, w: Weights, x: torch.Tensor, t: float,
            q_offset: int, ctx_k: Sequence[torch.Tensor],
            ctx_v: Sequence[torch.Tensor]):
    """One DiT pass over a chunk x [Tc, C] at time t, every context token
    in ``ctx_k``/``ctx_v`` (per layer [n, Hkv, D]) visible.  Returns the
    velocity [Tc, C] and the chunk's own per-layer K, V."""
    tc = x.shape[0]
    eps = cfg["norm_eps"]
    h = x.float() @ w.top("in_proj")
    silu_t = F.silu(time_embed(w, t, x.device))
    pos = q_offset + torch.arange(tc, device=x.device)
    ks, vs = [], []
    for i in range(cfg["n_layers"]):
        lw = w.layer(i)
        sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(
            silu_t @ lw["mod"] + lw["mod_b"], 6)
        a = rmsnorm(h, eps) * (1.0 + sc1) + sh1
        q, k, v = qkv(cfg, lw, a, pos)
        o = attention(q, torch.cat([ctx_k[i], k]), torch.cat([ctx_v[i], v]))
        h = h + g1 * (o @ lw["wo"])
        f = rmsnorm(h, eps) * (1.0 + sc2) + sh2
        h = h + g2 * (F.gelu(f @ lw["wi"], approximate="tanh") @ lw["wm"])
        ks.append(k)
        vs.append(v)
    sh, sc = torch.chunk(silu_t @ w.top("final_mod"), 2)
    h = rmsnorm(h, eps) * w.top("final_norm") * (1.0 + sc) + sh
    return h @ w.top("out_proj"), ks, vs


def replay(cfg: Dict, w: Weights, cond: torch.Tensor,
           noises: Sequence[torch.Tensor], served: Sequence[torch.Tensor],
           keys: Sequence[str], check: Iterable[int],
           page_quant: Optional[str] = None, page_tokens: int = 0,
           ) -> Tuple[Dict[int, Tuple[torch.Tensor, torch.Tensor]],
                      Dict[int, Tuple[torch.Tensor, torch.Tensor]]]:
    """Teacher-forced replay of one stream's first ``len(served)`` chunks.

    ``noises[k]`` is chunk k's initial latents and ``served[k]`` the chunk
    the program served, both [Tc, C]; ``keys[k]`` its logged fidelity.
    Returns, for each chunk index in ``check``, (reference chunk, noise):
    S Euler steps from the noise over the chunk's denoise context.
    ``page_quant`` overrides how every chunk's KV is stored (the control:
    "fp8" stores bfloat16-logged chunks as e4m3 pages).  Also returns, for
    every chunk whose clean pass ran, the first layer's stored K and V of
    its first ``page_tokens`` tokens."""
    check = set(check)
    tc = chunk_tokens(cfg)
    w_max = cfg["ardit_window_chunks"]
    sk, sv = sink_kv(cfg, w, cond)
    ring: List[Tuple[List[torch.Tensor], List[torch.Tensor]]] = []
    out: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    pages: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    last = max(check) if check else -1
    for n in range(min(len(served), last + 1)):
        fid = parse_key(keys[n])
        n_ctx = min(int(fid["window"]), n, w_max)
        chunks = ring[len(ring) - n_ctx:] if n_ctx else []

        def context(sparsity: float):
            idx = torch.as_tensor(visible_index(cfg, n_ctx, sparsity),
                                  device=cond.device)
            ck = [torch.cat([sk[i]] + [c[0][i] for c in chunks])[idx]
                  for i in range(cfg["n_layers"])]
            cv = [torch.cat([sv[i]] + [c[1][i] for c in chunks])[idx]
                  for i in range(cfg["n_layers"])]
            return ck, cv

        q_offset = cfg["cond_tokens"] + n * tc
        if n in check:
            ck, cv = context(float(fid["sparsity"]))
            grid = sigma_grid(int(fid["steps"]))
            x = noises[n].float()
            for s in range(int(fid["steps"])):
                vel, _, _ = forward(cfg, w, x, float(grid[s]), q_offset,
                                    ck, cv)
                x = x - float(grid[s] - grid[s + 1]) * vel
            out[n] = (x, noises[n].float())
            del ck, cv
        if n == last:
            break
        ck, cv = context(0.0)
        _, ks, vs = forward(cfg, w, served[n].float(), 0.0, q_offset, ck, cv)
        quant = page_quant or str(fid["quant"])
        ring.append(([store_kv(k, quant, cfg["kv_dtype"]) for k in ks],
                     [store_kv(v, quant, cfg["kv_dtype"]) for v in vs]))
        pages[n] = (ring[-1][0][0][:page_tokens], ring[-1][1][0][:page_tokens])
        ring = ring[-w_max:]
        del ck, cv
    return out, pages
