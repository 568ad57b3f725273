"""Elastic sequence parallelism (paper SS4.3 + App. C.3).

Last-resort recovery: when a stream's service credit is negative (it is
projected to miss its playout window even after priority scheduling and
re-homing), borrow ONE donor worker — the highest-credit RELAXED worker
in the same node — and switch the stream to the pre-initialized intra-node
SP2 group.  The donor is released at the next safe boundary once the
stream recovers to NORMAL (C_u >= 2 T_u).  All SP2 groups are
pre-initialized before serving (pre-compiled executables in the JAX
executor), so triggering elastic SP never creates communication groups on
the critical path; the head-partition KV transfer (App. C.4) goes through
the State Plane.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import queues
from repro_torch.core.types import ClusterView, Stream, Tier, Worker

RELEASE_FACTOR = 2.0          # release when C_u >= 2 * T_u (NORMAL tier)
MAX_SP = 2                    # intra-node SP2 only (App. C.3)


@dataclasses.dataclass(frozen=True)
class SPDecision:
    sid: int
    donor: int                # worker borrowed
    kind: str                 # "expand" | "release"


def plan_elastic_sp(view: ClusterView, now: float,
                    exclude: Optional[set] = None,
                    counts: Optional[Dict[int, Dict[Tier, int]]] = None,
                    donor_credits: Optional[Dict[int, float]] = None,
                    ) -> List[SPDecision]:
    """``exclude``: streams already helped this tick (e.g. just re-homed)
    — elastic SP is the NEXT line of defense, not a parallel one (SS4).
    ``counts``: the tick's tier histogram, passed by ``ControlPlane.tick``
    so both planners share one counting pass.  ``donor_credits``: per-
    worker min resident credit, precomputed in ONE pass by the vectorized
    control tick — queue contents don't change while planning, so the
    hoist is exact (the fallback recomputes per candidate donor)."""
    exclude = exclude or set()
    if counts is None:
        counts = queues.tier_counts(view)
    decisions: List[SPDecision] = []

    if donor_credits is not None:
        # vectorized tick: in overload almost every stream is C_u < 0
        # while almost no worker is RELAXED, so the scan order flips —
        # ONE pass over the streams collects releases + the borrowed
        # donor set + the C_u < 0 candidates, then the (few) donor-
        # eligible workers are bucketed per node.  Exact: releases
        # don't depend on other streams, each donor serves at most one
        # stream, the stable sort over the filtered subsequence visits
        # streams in the same order the full sort would, and the
        # per-node buckets preserve ``view.workers`` iteration order,
        # so each stream sees the identical donor list.
        borrowed: set = set()
        released: set = set()
        cands: List[Stream] = []
        for s in view.streams.values():
            d = s.sp_donor
            if d is not None:
                if (not s.done and s.t_next > 0.0
                        and s.credit >= RELEASE_FACTOR * s.t_next):
                    decisions.append(SPDecision(s.sid, d, "release"))
                    released.add(d)
                else:
                    borrowed.add(d)
            elif (not s.done and s.credit < 0.0
                    and s.sid not in exclude):
                cands.append(s)
        relaxed_by_node: Dict[int, List[Worker]] = {}
        for w in view.workers:
            if (not w.retired
                    and (w.donated_to is None or w.wid in released)
                    and queues.worker_class(counts[w.wid]) == "relaxed"):
                relaxed_by_node.setdefault(view.node_of(w.wid),
                                           []).append(w)
        if not relaxed_by_node:
            return decisions              # no donor anywhere this tick
        for s in sorted(cands, key=lambda s: s.credit):
            donors = [w for w in relaxed_by_node.get(view.node_of(s.home),
                                                     ())
                      if w.wid != s.home and w.wid not in borrowed]
            if not donors:
                continue
            donor = max(donors,
                        key=lambda w: donor_credits.get(w.wid,
                                                        float("inf")))
            borrowed.add(donor.wid)
            decisions.append(SPDecision(s.sid, donor.wid, "expand"))
        return decisions

    borrowed = {s.sp_donor for s in view.streams.values()
                if s.sp_donor is not None}

    # ---- releases first (free donors at safe boundaries) ------------------
    # t_next == 0.0 is the "no latency estimate yet" default (e.g.
    # use_fidelity=False, or before the first selection); comparing
    # credit against RELEASE_FACTOR * 0 would release every donor on
    # the very tick it was borrowed, so the check requires a real
    # estimate.  A donor released here rejoins the donor set below —
    # it is free again this tick, not stranded until the next one.
    released = set()
    for s in view.active_streams():
        if (s.sp_donor is not None and s.t_next > 0.0
                and s.credit >= RELEASE_FACTOR * s.t_next):
            decisions.append(SPDecision(s.sid, s.sp_donor, "release"))
            borrowed.discard(s.sp_donor)
            released.add(s.sp_donor)

    # ---- expansions: C_u < 0 streams, one donor each -----------------------
    for s in sorted(view.active_streams(), key=lambda s: s.credit):
        if (s.credit >= 0.0 or s.sp_donor is not None or s.done
                or s.sid in exclude):
            continue
        node = view.node_of(s.home)
        donors = [w for w in view.workers
                  if view.node_of(w.wid) == node and w.wid != s.home
                  and not w.retired
                  and (w.donated_to is None or w.wid in released)
                  and w.wid not in borrowed
                  and queues.worker_class(counts[w.wid]) == "relaxed"]
        if not donors:
            continue          # no same-node RELAXED donor: SP not triggered
        # credit-aware donor selection: highest-credit RELAXED worker
        def donor_credit(w: Worker) -> float:
            sids = list(w.queue) + ([w.running] if w.running
                                    is not None else [])
            if not sids:
                return float("inf")
            return min(view.streams[x].credit for x in sids)
        donor = max(donors, key=donor_credit)
        borrowed.add(donor.wid)
        decisions.append(SPDecision(s.sid, donor.wid, "expand"))
    return decisions


def apply_expand(view: ClusterView, dec: SPDecision) -> None:
    s = view.streams[dec.sid]
    s.sp_donor = dec.donor
    view.workers[dec.donor].donated_to = dec.sid


def apply_release(view: ClusterView, dec: SPDecision) -> None:
    s = view.streams[dec.sid]
    if s.sp_donor is not None:
        view.workers[s.sp_donor].donated_to = None
    s.sp_donor = None
