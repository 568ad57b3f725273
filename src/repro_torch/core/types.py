"""Shared control-plane state types (paper SS3.1, Table 1).

These are the *control-plane views*: plain dataclasses mutated by the
event loop (simulator or real executor).  All times are absolute seconds
on the driving clock.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.fidelity import FidelityConfig, HIGHEST_QUALITY


class Tier(enum.IntEnum):
    URGENT = 0
    NORMAL = 1
    RELAXED = 2


@dataclasses.dataclass
class Stream:
    """One real-time video generation session (Table 1)."""
    sid: int
    arrival: float
    target_chunks: int
    chunk_seconds: float              # playout seconds per chunk
    home: int                         # home worker id
    ttfc_slack: float                 # initial playout slack (SS3.3 step 1)

    # --- playout timeline ---
    next_deadline: float = 0.0        # ddl of the next (chunks_done+1) chunk
    chunks_done: int = 0
    first_chunk_time: Optional[float] = None
    ready_times: List[float] = dataclasses.field(default_factory=list)
    deadlines: List[float] = dataclasses.field(default_factory=list)
    stall_time: float = 0.0
    stall_events: List[float] = dataclasses.field(default_factory=list)
    qualities: List[float] = dataclasses.field(default_factory=list)
    fidelity_log: List[str] = dataclasses.field(default_factory=list)

    # --- execution state ---
    running_on: Optional[Tuple[int, ...]] = None   # worker ids (SP group)
    step_done: int = 0                # denoise steps finished in cur chunk
    chunk_started: Optional[float] = None
    next_fidelity: FidelityConfig = HIGHEST_QUALITY
    _t_next: float = dataclasses.field(default=0.0, repr=False)
    remaining: float = 0.0            # R_u estimate for running chunk

    # --- control state ---
    credit: float = 0.0
    tier: Tier = Tier.NORMAL
    cooldown_until: float = -1e9      # re-homing cooldown (App. C.2)
    sp_donor: Optional[int] = None    # borrowed worker (SS4.3)
    resident_on: Set[int] = dataclasses.field(default_factory=set)
    paused_until: float = -1.0
    done: bool = False
    # heterogeneous co-serving: which model bundle backs this stream
    # (None on single-model paths — every consumer treats None as the
    # session's one model, so legacy behavior is untouched)
    model: Optional[str] = None

    @property
    def t_next(self) -> float:
        """T_u (Eq. 1): profiled *latency* of the next chunk — a
        DURATION in driving-clock seconds, never an absolute completion
        time.  Both writers (the simulator's cost model and the real
        session's ``_begin_if_needed``) must store the same unit; the
        elastic-SP release guard compares it against ``credit`` (also a
        duration), so an absolute timestamp here silently disables
        release.  The setter rejects values that cannot be a latency."""
        return self._t_next

    @t_next.setter
    def t_next(self, latency: float) -> None:
        if not (isinstance(latency, (int, float))
                and math.isfinite(latency) and latency >= 0.0):
            raise ValueError(
                f"t_next must be a finite non-negative duration (T_u), "
                f"got {latency!r} — absolute timestamps are a unit bug")
        self._t_next = float(latency)

    @property
    def finished(self) -> bool:
        return self.chunks_done >= self.target_chunks

    def playout_slack(self, now: float) -> float:
        """P_u: remaining playable buffer ahead of the playout cursor."""
        return self.next_deadline - now


@dataclasses.dataclass
class Worker:
    """One GPU / one model replica (SS3.1 footnote 3)."""
    wid: int
    node: int
    queue: List[int] = dataclasses.field(default_factory=list)  # stream ids
    running: Optional[int] = None          # stream currently executing
    donated_to: Optional[int] = None       # stream borrowing this worker
    sent_this_tick: int = 0
    recv_this_tick: int = 0
    # front-door scale-in: a retired worker keeps its wid slot (wids
    # index per-worker arrays everywhere) but receives no dispatches,
    # re-homings, SP donations, or admissions until revived
    retired: bool = False

    def load(self, weight: Optional[Callable[[int], float]] = None):
        """Queued + running + donated: a worker lending itself as an
        SP2 half (SS4.3) is occupied even though the borrowed stream
        never appears in its own queue.

        With ``weight`` (sid -> per-model placement weight, heterogeneous
        co-serving) each occupant counts its weight instead of 1 — a
        cheap SSM stream occupies less of a worker than a heavy MoE
        stream.  Without it the exact integer count is returned, so
        single-model argmins are unchanged."""
        if weight is None:
            return (len(self.queue) + (1 if self.running is not None else 0)
                    + (1 if self.donated_to is not None else 0))
        load = sum(weight(sid) for sid in self.queue)
        if self.running is not None:
            load += weight(self.running)
        if self.donated_to is not None:
            load += weight(self.donated_to)
        return load


@dataclasses.dataclass
class ClusterView:
    """Everything the Control Plane sees at a tick."""
    streams: Dict[int, Stream]
    workers: List[Worker]
    workers_per_node: int = 8
    # heterogeneous co-serving: sid -> placement weight of the stream's
    # model bundle; None keeps placement on the integer queue-depth path
    stream_weight: Optional[Callable[[int], float]] = None

    def node_of(self, wid: int) -> int:
        return self.workers[wid].node

    def active_streams(self) -> List[Stream]:
        return [s for s in self.streams.values() if not s.done]
