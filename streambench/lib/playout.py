"""The playout rule and the end-to-end arithmetic, recomputed from ready
times alone (the program's own deadlines are never read).

A stream's playout starts when its first chunk is ready; the wait from its
scheduled arrival is its time to first chunk (TTFC).  Chunk k + 1 is due one
chunk of playout after chunk k's deadline, and after a late chunk playout
resumes when that chunk is ready: ``next = max(deadline, ready) + 0.75``,
the session's own rule, with no deadline derived from the program's
measured speed.

Every stream scheduled to arrive before the stop counts, served or not.  A
stream with no chunk ready by the stop enters the TTFC tail at ``stop -
arrival``.  A stream the program refused never plays: each of its chunks
is due at ``arrival + k * 0.75`` and lost, and those in the window count as
failed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class StreamRecord:
    sid: int
    arrival: float                 # scheduled, session seconds
    target: int                    # chunks asked for
    ready: List[float]             # session seconds, in playout order
    keys: List[str]                # fidelity of each ready chunk
    refused: bool = False          # turned away by the program


@dataclasses.dataclass
class Window:
    start: float                   # session seconds
    end: float
    stop: float                    # when the session was stopped (>= end)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def holds(self, t: float) -> bool:
        return self.start <= t < self.end


def deadlines(ready: Sequence[float], chunk_s: float):
    """(deadline of each ready chunk, deadline of the first chunk not yet
    ready; None before playout starts)."""
    if not ready:
        return [], None
    out, nxt = [], ready[0]
    for r in ready:
        out.append(nxt)
        nxt = max(nxt, r) + chunk_s
    return out, nxt


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear interpolation between order statistics (numpy's default)."""
    s = sorted(xs)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


@dataclasses.dataclass
class Playout:
    due: int              # chunks due in the window
    on_time: int
    failed: int           # due chunks of refused streams
    arrivals: int         # streams arriving in the window
    ttfc: List[float]     # their TTFC, censored at the stop when unserved
    censored: int
    ready_in_window: int
    keys_in_window: List[str]

    @property
    def cpr(self) -> Optional[float]:
        return self.on_time / self.due if self.due else None


def playout(streams: Sequence[StreamRecord], win: Window,
            chunk_s: float) -> Playout:
    due = on_time = failed = censored = ready_in = 0
    ttfc: List[float] = []
    keys: List[str] = []
    for s in streams:
        if s.refused:
            lost = sum(win.holds(s.arrival + k * chunk_s)
                       for k in range(s.target))
            due += lost
            failed += lost
        ddls, nxt = deadlines(s.ready, chunk_s)
        for r, ddl in zip(s.ready, ddls):
            if win.holds(ddl):
                due += 1
                on_time += r <= ddl
        if nxt is not None and len(s.ready) < s.target and win.holds(nxt):
            due += 1                       # due, never ready by the stop
        if win.holds(s.arrival):
            if s.ready:
                ttfc.append(s.ready[0] - s.arrival)
            else:
                ttfc.append(win.stop - s.arrival)
                censored += 1
        for r, key in zip(s.ready, s.keys):
            if win.holds(r):
                ready_in += 1
                keys.append(key)
    return Playout(due, on_time, failed, len(ttfc), ttfc, censored, ready_in,
                   keys)


def live_counts(streams: Sequence[StreamRecord], times: Sequence[float]
                ) -> List[int]:
    """Streams arrived and not yet fully generated at each time."""
    out = []
    for t in times:
        n = 0
        for s in streams:
            if s.arrival <= t and not (len(s.ready) >= s.target
                                       and s.ready[-1] <= t):
                n += 1
        out.append(n)
    return out


def summary(p: Playout, win: Window) -> Dict[str, float]:
    out: Dict[str, float] = {"due": p.due, "on_time": p.on_time,
                             "failed": p.failed,
                             "arrivals": p.arrivals,
                             "censored": p.censored,
                             "ready": p.ready_in_window}
    if p.cpr is not None:
        out["cpr"] = p.cpr
    if p.ttfc:
        out["ttfc_p95_s"] = percentile(p.ttfc, 0.95)
    out["chunks_per_s"] = p.ready_in_window / win.seconds
    return out
