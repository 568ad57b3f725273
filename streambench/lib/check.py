"""What decides ``correct``: the program's served chunks against the plain
reference, and the session's assembly of them.

Run after the window has closed, the peak memory read and the program's
state freed.  Numbers compared:

* ``assembly_faults``: over every stream, a chunk count that disagrees
  between ready times, fidelity log and served chunks, more chunks than
  asked for, ready times that go back, a first chunk before the arrival, or
  a served chunk of the wrong shape or not finite.  Limit 0.
* ``chunk_gap``: the widest gap of a served latent token from the
  reference's, over the sampled chunks: ``max_t |served_t - reference_t|``
  (the norm over the token's channels) over the root mean square of
  ``|reference_t - noise_t|``, what the model moved a token from its noise.  The sample, drawn from
  the seed, is the stream with the most served chunks and one more stream,
  in each its last served chunk (the deepest context) and up to three
  earlier ones.
* ``kv_page_gap``: the worst, over every bfloat16-logged chunk of the
  sampled streams before their last checked one, of ``rms(page - reference) /
  rms(reference)`` for the first layer's K and V as the pool held them right
  after the chunk's write (its first ``PAGE_TOKENS`` tokens), against the
  reference's clean pass stored as the logged fidelity stores it.  The
  first layer is where the program's own bfloat16 arithmetic adds least,
  so the storage precision of the pages shows.
* ``chunks_compared``: at least this many.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

import torch

from streambench.lib import inputs
from streambench.lib.serve import PAGE_TOKENS, RunRecord
from streambench.reference import ardit as ref

BAD = 1e30           # printed for a number that is not finite


def assembly_faults(rec: RunRecord, cfg: Dict) -> int:
    tc = ref.chunk_tokens(cfg)
    faults = 0
    for s in rec.streams:
        chunks = rec.served.get(s.sid, [])
        n = len(s.ready)
        faults += not (n == len(s.keys) == len(chunks))
        faults += n > s.target
        faults += any(b < a for a, b in zip(s.ready, s.ready[1:]))
        faults += bool(s.ready) and s.ready[0] < s.arrival
        for c in chunks:
            faults += tuple(c.shape) != (tc, cfg["latent_channels"])
            faults += not bool(torch.isfinite(c).all())
    return faults


def sample(rec: RunRecord, seed: int, n_streams: int = 2,
           n_chunks: int = 4) -> Dict[int, List[int]]:
    """sid -> chunk indices to compare."""
    rng = random.Random(seed)
    served = sorted((s.sid for s in rec.streams if rec.served.get(s.sid)),
                    key=lambda sid: (-len(rec.served[sid]), sid))
    if not served:
        return {}
    picks = [served[0]] + rng.sample(served[1:],
                                     min(n_streams - 1, len(served) - 1))
    out = {}
    for sid in picks:
        n = len(rec.served[sid])
        earlier = rng.sample(range(n - 1), min(n_chunks - 1, n - 1))
        out[sid] = sorted(set(earlier) | {n - 1})
    return out


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """rms(got - want) / rms(want)."""
    return float(torch.sqrt(torch.mean((got.float() - want) ** 2))
                 / torch.sqrt(torch.mean(want ** 2)))


def token_gap(got: torch.Tensor, want: torch.Tensor,
              base: torch.Tensor) -> float:
    """Widest per-token distance of ``got`` [T, C] from ``want``, over the
    rms per-token distance of ``want`` from ``base``."""
    err = torch.linalg.vector_norm(got.float() - want, dim=-1)
    moved = torch.sqrt(torch.mean(torch.sum((want - base) ** 2, dim=-1)))
    return float(err.max() / moved)


def gaps(rec: RunRecord, cfg: Dict, seed: int, device,
         picks: Dict[int, List[int]],
         keys_of: Optional[Dict[int, List[str]]] = None
         ) -> Tuple[List[float], List[float]]:
    """(chunk gaps of the sampled chunks, page gaps of every page the
    replays reach).  ``keys_of`` overrides the logged fidelity keys the
    reference is told (the control)."""
    ref.strict_fp32()
    w = ref.Weights(rec.params, cfg["n_layers"])
    by_sid = {s.sid: s for s in rec.streams}
    chunk, page = [], []
    with torch.no_grad():
        for sid, idx in picks.items():
            served = rec.served[sid]
            keys = (keys_of or {}).get(sid, by_sid[sid].keys)
            noises = [inputs.noise(cfg, seed, sid, k, device)[0]
                      for k in range(max(idx) + 1)]
            cond = inputs.cond(cfg, seed, sid, device)
            out, pages = ref.replay(cfg, w, cond, noises, served, keys, idx,
                                    page_tokens=PAGE_TOKENS)
            for k in idx:
                x_ref, x0 = out[k]
                chunk.append(token_gap(served[k], x_ref, x0))
            for n, (k_ref, v_ref) in pages.items():
                got = rec.pages.get((sid, n))
                # e4m3 pages: the program's bf16 arithmetic moves values
                # across the coarse e4m3 grid, so they read like the
                # control; later chunks' chunk_gap covers them
                if got is not None and ref.parse_key(keys[n])["quant"] \
                        != "fp8":
                    page.append(max(rel_gap(got[0], k_ref),
                                    rel_gap(got[1], v_ref)))
    return chunk, page


def worst(xs: List[float]) -> float:
    """The largest; BAD for a NaN or inf, 0 when nothing was compared."""
    if not all(math.isfinite(x) for x in xs):
        return BAD
    return max(xs, default=0.0)


def check(rec: RunRecord, cfg: Dict, seed: int, device,
          keys_of: Optional[Dict[int, List[str]]] = None
          ) -> Dict[str, Dict]:
    """Each number compared, with its limit, and whether it holds (a limit
    not yet set holds nothing).  ``keys_of`` as in ``chunk_gaps``."""
    limits = cfg["limits"]
    chunk, page = gaps(rec, cfg, seed, device, sample(rec, seed),
                       keys_of=keys_of)
    nums = {"assembly_faults": float(assembly_faults(rec, cfg)),
            "chunk_gap": worst(chunk),
            "kv_page_gap": worst(page),
            "chunks_compared": float(len(chunk))}
    out = {}
    for name, value in nums.items():
        limit = limits[name]
        if limit is None:
            ok = False
        else:
            ok = value >= limit if name == "chunks_compared" \
                else value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    out["chunk_gap"]["each"] = chunk
    out["kv_page_gap"]["each"] = page
    return out
