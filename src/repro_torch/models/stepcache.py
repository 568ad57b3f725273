"""Content-adaptive step cache (AdaCache-style residual reuse), the
fifth fidelity knob (``FidelityConfig.cache in {off, conservative,
aggressive}``).

The residual (velocity) a denoise step predicts changes little between
adjacent steps on stable content, so a step whose *measured* inter-step
residual delta fell under a threshold reuses the cached velocity
instead of recomputing the attention + MLP stack: the Euler update
collapses to the AXPY ``x - dt * v_cached``.  BMPR routes over the knob
like steps / sparsity / window / quant, so slack-poor streams take
cached steps before degrading window or resolution.

* ``ResidualPool``: device buffers keyed like the KV pool (slot table +
  LIFO free list): per slot the velocity ``v [1, tc, C]`` of the last
  computed step and a per-layer feature signature ``feats [L]`` (mean
  |k_l| of that step's fresh chunk KV).  ``_record`` writes a slot's
  rows in place, issued asynchronously with the step.
* ``StepCacheManager``: host-side per-stream tracker.  After every
  COMPUTED denoise step it issues (on the device, no sync) the combined
  residual delta

      delta = max( mean|v - v_prev| / (mean|v_prev| + eps),
                   mean|f - f_prev| / (mean|f_prev| + eps) )

  as a 0-d device tensor, read (``float``) only at the next step's hit
  decision, so the executor's no-mid-chunk-sync pipelining survives
  (the read waits at most until the already-enqueued launch retires).
* Motion regularizer (AdaCache's MoReg at chunk granularity): the
  chunk-to-chunk latent delta of the stream's last two completed chunks
  scales the threshold down (``base / (1 + MOREG_WEIGHT * motion)``).

Hit eligibility (per denoise step): cache level != off, at least two
computed velocities this chunk, consecutive reuses under the level's
cap, and delta under the motion-scaled threshold.  The clean (context)
pass never hits: it writes the chunk's KV pages.  Cache state is
per-chunk transient: spill / restore / migration and prompt switches
drop it (the next chunk re-tracks from its first computed steps).

Dtypes follow the reference: the velocity lands in the fp32 pool, the
KV signature is a mean in k's dtype, and a hit returns ``x - dt * v``
promoted to fp32.  The serving path's latents are fp32 at every width
(chunk noise is fp32 and the Euler update keeps x's dtype); only the
KV signature sees bf16 at full width.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

EPS = 1e-6

# Base residual-delta thresholds per cache level.  Conservative only
# reuses when the velocity field is nearly frozen (5% relative change);
# aggressive reuses up to a full 100% relative change.  Both scale DOWN
# with measured motion.
THRESHOLDS = {"conservative": 0.05, "aggressive": 1.0}
# Consecutive-reuse caps: how many steps in a row may ride one cached
# velocity before a recompute is forced.
MAX_CONSECUTIVE = {"conservative": 1, "aggressive": 2}
MOREG_WEIGHT = 4.0


@torch.no_grad()
def _record(v_pool: torch.Tensor, f_pool: torch.Tensor, slot: int,
            x_old: torch.Tensor, x_new: torch.Tensor, dt: torch.Tensor,
            k_row: torch.Tensor) -> torch.Tensor:
    """One computed step's bookkeeping: recover the velocity
    ``v = (x_old - x_new) / dt``, build the per-layer KV signature
    ``[L, tc, H, Dh] -> [L]`` mean |k|, compute the combined relative
    residual delta against the slot's previous entry, and write both
    pool rows in place.  ``dt`` is a 0-d fp32 tensor on x's device: on
    the card, division by a Python float would become a product with its
    rounded reciprocal.  The difference and ``dt`` round to x's dtype
    and the quotient stays fp32, as XLA computes the reference's
    ``(x_old - x_new) / dt`` for the fp32 pool.  Returns the 0-d device
    delta (not read here)."""
    v_new = (x_old - x_new).float() / dt.to(x_old.dtype).float()
    f_new = k_row.abs().mean(dim=(1, 2, 3))
    v_prev = v_pool[slot]
    f_prev = f_pool[slot]
    dv = (v_new - v_prev).abs().mean() / (v_prev.abs().mean() + EPS)
    df = (f_new - f_prev).abs().mean() / (f_prev.abs().mean() + EPS)
    delta = torch.maximum(dv, df)
    v_pool[slot] = v_new
    f_pool[slot] = f_new
    return delta


@torch.no_grad()
def _apply_cached(x: torch.Tensor, v_pool: torch.Tensor, slot: int,
                  dt: float) -> torch.Tensor:
    """The cache-hit Euler step ``x - dt * v_cached``: an AXPY, no
    attention and no MLP, one fused multiply-add per element (as XLA
    contracts it)."""
    return torch.add(x, v_pool[slot], alpha=-dt)


@dataclasses.dataclass
class StreamCacheState:
    """Host-side per-stream, per-chunk tracker state."""
    slot: int
    n_computed: int = 0            # computed velocities this chunk
    consecutive: int = 0           # reuses riding the current velocity
    motion: float = 0.0            # chunk-to-chunk latent delta
    delta: Optional[torch.Tensor] = None   # 0-d device tensor, read lazily


class ResidualPool:
    """Cached-velocity buffers on ``device``, keyed like the KV pool: a
    slot per tracked stream, host free list, rows written in place."""

    def __init__(self, n_slots: int, chunk_tokens: int, latent_ch: int,
                 n_layers: int, device="cuda"):
        self.n_slots = n_slots
        self.v = torch.zeros((n_slots, 1, chunk_tokens, latent_ch),
                             dtype=torch.float32, device=device)
        self.feats = torch.zeros((n_slots, n_layers), dtype=torch.float32,
                                 device=device)
        self._free: List[int] = list(range(n_slots - 1, -1, -1))

    def alloc(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def free(self, slot: int) -> None:
        self._free.append(slot)


class StepCacheManager:
    """Per-executor step-cache bookkeeping: slot lifecycle, hit
    decisions, residual tracking, hit/miss accounting."""

    def __init__(self, n_slots: int, chunk_tokens: int, latent_ch: int,
                 n_layers: int, device="cuda"):
        self.pool = ResidualPool(n_slots, chunk_tokens, latent_ch,
                                 n_layers, device=device)
        self.states: Dict[int, StreamCacheState] = {}
        self.hits = 0
        self.misses = 0
        # 0-d divisors per dt: filled once on the device, so a record
        # issues no host-to-device copy (a copy would sync)
        self._dt: Dict[float, torch.Tensor] = {}

    # ---- lifecycle ---------------------------------------------------------
    def begin_chunk(self, sid: int,
                    history: Optional[Sequence[torch.Tensor]]) -> None:
        """Reset the per-chunk tracker and measure motion from the last
        two COMPLETED chunks (a host read: their chunk already synced).
        Chunks 0 and 1 get neutral motion 0."""
        st = self.states.get(sid)
        if st is None:
            slot = self.pool.alloc()
            if slot is None:            # slots exhausted: never hits
                return
            st = StreamCacheState(slot=slot)
            self.states[sid] = st
        st.n_computed = 0
        st.consecutive = 0
        st.delta = None
        st.motion = 0.0
        if history is not None and len(history) >= 2:
            prev = history[-1].detach().float().cpu().numpy()
            prev2 = history[-2].detach().float().cpu().numpy()
            st.motion = float(np.mean(np.abs(prev - prev2))
                              / (np.mean(np.abs(prev2)) + EPS))

    def drop(self, sid: int) -> None:
        """Free the stream's slot and forget its tracker (retire,
        migration export, spill): cache state is per-chunk transient
        and deliberately not carried; the next chunk re-tracks."""
        st = self.states.pop(sid, None)
        if st is not None:
            self.pool.free(st.slot)

    def reset_chunk(self, sid: int) -> None:
        """Invalidate mid-chunk state (abort / prompt switch) but keep
        the slot for the stream's next chunk."""
        st = self.states.get(sid)
        if st is not None:
            st.n_computed = 0
            st.consecutive = 0
            st.delta = None

    # ---- the decision ------------------------------------------------------
    def effective_threshold(self, level: str, motion: float) -> float:
        return THRESHOLDS[level] / (1.0 + MOREG_WEIGHT * motion)

    def should_hit(self, sid: int, level: str) -> bool:
        """Hit decision for the NEXT denoise step of ``sid``.  Reads the
        lazily issued delta (waits at most until the previous launch
        retires).  Counts the decision (hit or miss)."""
        st = self.states.get(sid)
        hit = False
        if (st is not None and level != "off"
                and st.n_computed >= 2
                and st.consecutive < MAX_CONSECUTIVE[level]
                and st.delta is not None):
            hit = (float(st.delta)
                   < self.effective_threshold(level, st.motion))
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        return hit

    # ---- state updates -----------------------------------------------------
    def apply_hit(self, sid: int, x: torch.Tensor,
                  dt: float) -> torch.Tensor:
        """The reused Euler step: ``x - dt * v_cached``."""
        st = self.states[sid]
        st.consecutive += 1
        return _apply_cached(x, self.pool.v, st.slot, dt)

    def record_step(self, sid: int, x_old: torch.Tensor,
                    x_new: torch.Tensor, dt: float,
                    k_row: torch.Tensor) -> None:
        """After a COMPUTED denoise step: recover the velocity, build the
        per-layer KV signature, and (from the second computed step on)
        keep the residual delta, all issued on the device with no
        sync (the delta is read lazily at the next hit decision)."""
        st = self.states.get(sid)
        if st is None or dt == 0.0:
            return
        dt_t = self._dt.get(dt)
        if dt_t is None:
            dt_t = torch.full((), dt, dtype=torch.float32,
                              device=self.pool.v.device)
            self._dt[dt] = dt_t
        delta = _record(self.pool.v, self.pool.feats, st.slot, x_old, x_new,
                        dt_t, k_row)
        if st.n_computed >= 1:      # first step has no previous entry
            st.delta = delta
        st.n_computed += 1
        st.consecutive = 0

    # ---- reporting ---------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0}
