"""Three-tier priority queues and credit-aware eviction (paper SS4.1).

At each control tick the Control Plane orders every worker's queue by
service credit ascending (lower credit dispatches first), giving local
preemption at step/chunk boundaries.  Credit-aware eviction frees KV-pool
residency by evicting the *highest*-credit resident stream — the one
least likely to stall (Fig. 8).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Union

from repro_torch.core.types import ClusterView, Stream, Tier, Worker


def order_queue(worker: Worker, streams: Dict[int, Stream]) -> None:
    """Sort the worker's queue by service credit (ascending)."""
    worker.queue.sort(key=lambda sid: streams[sid].credit)


def order_all(view: ClusterView) -> None:
    for w in view.workers:
        order_queue(w, view.streams)


def next_dispatch_set(worker: Worker, streams: Dict[int, Stream],
                      now: float,
                      max_batch: Optional[int] = None) -> List[int]:
    """Credit-ordered runnable streams on this worker, lowest credit
    first, up to ``max_batch`` (paused/migrating streams are skipped;
    atomic safety keeps mid-transfer streams out of the queue entirely,
    SS4.4).  The batched executor composes its denoise-step micro-batch
    from this set; ``next_dispatch`` is the sequential special case."""
    out: List[int] = []
    for sid in worker.queue:
        s = streams[sid]
        if s.done or s.finished:
            continue
        if s.paused_until > now:
            continue
        out.append(sid)
        if max_batch is not None and len(out) >= max_batch:
            break
    return out


def next_dispatch(worker: Worker, streams: Dict[int, Stream],
                  now: float) -> Optional[int]:
    """Lowest-credit runnable stream on this worker (or None)."""
    sids = next_dispatch_set(worker, streams, now, max_batch=1)
    return sids[0] if sids else None


def pick_eviction(resident_sids: List[int], streams: Dict[int, Stream],
                  protect: Union[int, Iterable[int], None] = None,
                  ) -> Optional[int]:
    """Credit-aware eviction: evict the highest-credit resident stream
    (the one least likely to stall, Fig. 8).

    ``protect`` is a sid — or an iterable of sids — that must not be
    chosen: the stream being admitted plus any in-flight streams whose
    gathered context still references pool pages.  Credit ties break
    deterministically toward the LOWEST sid, so a replayed schedule
    evicts identically."""
    if protect is None:
        shield = frozenset()
    elif isinstance(protect, Iterable):
        shield = frozenset(protect)
    else:
        shield = frozenset((protect,))
    candidates = [sid for sid in resident_sids if sid not in shield]
    if not candidates:
        return None
    return max(candidates, key=lambda sid: (streams[sid].credit, -sid))


def pick_page_eviction(resident_sids: List[int], streams: Dict[int, Stream],
                       protect: Union[int, Iterable[int], None] = None,
                       has_evictable=None) -> Optional[int]:
    """Page-granular eviction victim: the highest-credit resident that
    still has an evictable ring page (``has_evictable(sid)``, supplied
    by the pool — a stream degraded down to its floor drops out of the
    candidate set).  Same protections and deterministic tie-break as
    ``pick_eviction``; this is the FIRST rung of the degradation ladder
    (trade one stream's window W down by a page) before whole-stream
    spill."""
    if protect is None:
        shield = frozenset()
    elif isinstance(protect, Iterable):
        shield = frozenset(protect)
    else:
        shield = frozenset((protect,))
    candidates = [sid for sid in resident_sids if sid not in shield
                  and (has_evictable is None or has_evictable(sid))]
    if not candidates:
        return None
    return max(candidates, key=lambda sid: (streams[sid].credit, -sid))


def tier_counts(view: ClusterView) -> Dict[int, Dict[Tier, int]]:
    """Per-worker tier histogram over queued + running streams."""
    out: Dict[int, Dict[Tier, int]] = {}
    streams = view.streams
    for w in view.workers:
        u = nrm = r = 0
        for sid in w.queue:
            t = streams[sid].tier
            if t is Tier.URGENT:
                u += 1
            elif t is Tier.NORMAL:
                nrm += 1
            else:
                r += 1
        if w.running is not None:
            t = streams[w.running].tier
            if t is Tier.URGENT:
                u += 1
            elif t is Tier.NORMAL:
                nrm += 1
            else:
                r += 1
        out[w.wid] = {Tier.URGENT: u, Tier.NORMAL: nrm, Tier.RELAXED: r}
    return out


def worker_class(counts: Dict[Tier, int]) -> str:
    """URGENT-heavy / RELAXED-only / mixed (SS4.2 terminology)."""
    if counts[Tier.URGENT] > 0:
        return "urgent"
    if counts[Tier.NORMAL] == 0:
        return "relaxed"
    return "mixed"


def worker_class_triple(view: ClusterView) -> tuple:
    """(n_urgent, n_mixed, n_relaxed) worker counts in ONE pass —
    exactly ``worker_class(tier_counts(view)[wid])`` tallied over all
    workers, without materializing the per-worker histograms (the fleet
    tick samples this every 3 simulated seconds)."""
    n_urgent = n_mixed = n_relaxed = 0
    streams = view.streams
    for w in view.workers:
        urgent = False
        normal = False
        for sid in w.queue:
            t = streams[sid].tier
            if t == Tier.URGENT:
                urgent = True
                break
            if t == Tier.NORMAL:
                normal = True
        else:
            if w.running is not None:
                t = streams[w.running].tier
                if t == Tier.URGENT:
                    urgent = True
                elif t == Tier.NORMAL:
                    normal = True
        if urgent:
            n_urgent += 1
        elif normal:
            n_mixed += 1
        else:
            n_relaxed += 1
    return (n_urgent, n_mixed, n_relaxed)


def min_credits(view: ClusterView) -> Dict[int, float]:
    """Per-worker minimum credit over queued + running streams (inf for
    an idle worker) — the elastic-SP donor-quality signal, hoisted to
    one pass per tick."""
    out: Dict[int, float] = {}
    streams = view.streams
    for w in view.workers:
        best = float("inf")
        for sid in w.queue:
            c = streams[sid].credit
            if c < best:
                best = c
        if w.running is not None:
            c = streams[w.running].credit
            if c < best:
                best = c
        out[w.wid] = best
    return out
