"""Bipartite Re-homing Planning (paper Algorithm 1 + App. C.2).

Senders: URGENT-heavy workers.  Receivers: workers with no URGENT or
NORMAL streams (slack headroom only).  Safeguards: per-stream 60 s
cooldown, per-tick caps (send <= 2, recv <= 1), intra-node receivers
preferred before cross-node ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import queues
from repro_torch.core.types import ClusterView, Stream, Tier, Worker

COOLDOWN_S = 60.0
CAP_SEND = 2
CAP_RECV = 1


@dataclasses.dataclass(frozen=True)
class Migration:
    sid: int
    src: int
    dst: int
    cross_node: bool


def plan_rehoming(view: ClusterView, now: float,
                  cooldown_s: float = COOLDOWN_S,
                  cap_send: int = CAP_SEND,
                  cap_recv: int = CAP_RECV,
                  counts: Optional[Dict[int, Dict[Tier, int]]] = None,
                  ) -> List[Migration]:
    # the caller (ControlPlane.tick) may pass the tick's tier histogram
    # so the two planners share ONE O(streams) counting pass
    if counts is None:
        counts = queues.tier_counts(view)
    # a worker serving someone else's SP2 half is NOT slack headroom:
    # its donated compute is invisible to its own tier counts (the
    # borrowed stream is homed elsewhere), so without this filter a
    # migration could land on a lane that is already busy donating
    receivers = [w for w in view.workers
                 if w.donated_to is None and not w.retired
                 and queues.worker_class(counts[w.wid]) == "relaxed"]
    if not receivers:
        # fleet-overload fast exit: with nowhere to re-home to, the
        # sender scan below is a dead O(streams) pass (no migration —
        # and no cooldown burn — can happen without a receiver)
        return []
    # senders are URGENT-HEAVY workers (congested URGENT queues, Alg. 1
    # line 1): at least one urgent stream is WAITING (queued, not being
    # served) — an urgent stream already on the GPU is not congestion
    def queued_urgent(w: Worker) -> int:
        return sum(1 for sid in w.queue
                   if view.streams[sid].tier == Tier.URGENT
                   and view.streams[sid].running_on is None)
    senders = [w for w in view.workers if queued_urgent(w) >= 1]
    # most-pressured senders first
    senders.sort(key=lambda w: -counts[w.wid][Tier.URGENT])

    sent: Dict[int, int] = {w.wid: 0 for w in view.workers}
    recv: Dict[int, int] = {w.wid: 0 for w in view.workers}
    plan: List[Migration] = []

    for src in senders:
        # movable: queued URGENT streams not in cooldown, not running,
        # and not mid-SP2 — a stream borrowing a donor is already being
        # helped (SS4's escalation order), and its head-partition state
        # spans two workers, so re-homing it is not a clean page move.
        # (Planning it anyway would also burn its cooldown on a
        # migration the apply layer refuses.)
        movable = [view.streams[sid] for sid in src.queue
                   if view.streams[sid].tier == Tier.URGENT
                   and view.streams[sid].cooldown_until <= now
                   and view.streams[sid].running_on is None
                   and view.streams[sid].sp_donor is None]
        movable.sort(key=lambda s: s.credit)          # lowest credit first
        for s in movable:
            if sent[src.wid] >= cap_send:
                break
            # intra-node-first receiver order (line 5)
            cands = sorted(
                (r for r in receivers if recv[r.wid] < cap_recv
                 and r.wid != src.wid),
                key=lambda r: (view.node_of(r.wid) != view.node_of(src.wid),
                               r.load()))
            if not cands:
                break
            dst = cands[0]
            plan.append(Migration(
                s.sid, src.wid, dst.wid,
                cross_node=view.node_of(dst.wid) != view.node_of(src.wid)))
            sent[src.wid] += 1
            recv[dst.wid] += 1
            s.cooldown_until = now + cooldown_s
    return plan


def apply_migration(view: ClusterView, mig: Migration) -> None:
    """Move the stream's home + queue entry (KV moves via the State
    Plane; the caller couples this with a transfer request)."""
    s = view.streams[mig.sid]
    src, dst = view.workers[mig.src], view.workers[mig.dst]
    if mig.sid in src.queue:
        src.queue.remove(mig.sid)
    dst.queue.append(mig.sid)
    s.home = mig.dst
