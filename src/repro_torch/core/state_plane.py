"""State Plane (paper SS4.4, Fig. 9, App. D.2).

Unified KV management: each worker owns a paged pool (kappa = 0.8 of
VRAM), pages at latent-frame granularity, logical page table per stream.
Credit-aware eviction (SS4.1), re-homing (SS4.2) and elastic SP (SS4.3)
all move state through ONE interface:

    transfer(stream, src, dst, page_range)

executed by an async transfer engine with three protocols (Fig. 13):

    sync             dispatcher blocked until the full transfer completes
    async-nostream   submitted asynchronously; destination compute starts
                     only after the full state arrives
    async-stream     layer-wise streaming: the stream is re-queued once
                     its FIRST layer is resident (atomic safety), later
                     layers overlap with computation

Timing model (CPU container; constants mirror the paper's testbed — see
``repro_torch.sched_sim.cost_model`` for derivations): NVLink-class intra-node
effective bandwidth, IB-class cross-node, fixed submission overhead.  In
the JAX executor the same engine issues device-to-device copies.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set, Tuple

# ---------------------------------------------------------------------------
# paged pool
# ---------------------------------------------------------------------------


class PagedKVPool:
    """Physical page pool of one worker; frame-granularity pages."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free: int = n_pages
        self.tables: Dict[int, int] = {}      # sid -> pages held

    def resident(self, sid: int) -> bool:
        return sid in self.tables

    def pages_of(self, sid: int) -> int:
        return self.tables.get(sid, 0)

    def can_alloc(self, n: int) -> bool:
        return self.free >= n

    def alloc(self, sid: int, n: int) -> bool:
        if self.free < n:
            return False
        self.free -= n
        self.tables[sid] = self.tables.get(sid, 0) + n
        return True

    def release(self, sid: int) -> int:
        n = self.tables.pop(sid, 0)
        self.free += n
        return n

    def release_pages(self, sid: int, n: int) -> None:
        """Give back ``n`` of ``sid``'s pages without releasing the
        stream (page-granular partial-window eviction: the stream stays
        resident with a smaller effective window)."""
        held = self.tables.get(sid, 0)
        assert held >= n, \
            f"stream {sid} holds {held} pages, cannot release {n}"
        self.tables[sid] = held - n
        self.free += n

    def resident_sids(self) -> List[int]:
        return list(self.tables)

    @property
    def used(self) -> int:
        return self.n_pages - self.free

    def check(self) -> None:
        """Page-conservation invariant: every page is either free or in
        exactly one table.  Raises AssertionError on accounting drift
        (the device-side pool mirrors into this class, so the property
        suite leans on it).  Zero-page tables are legal: the simulator
        admits a restored stream with ``alloc(sid, min(want, free))``,
        which is 0 under full pressure."""
        assert self.free >= 0, "negative free-page count"
        assert all(n >= 0 for n in self.tables.values()), \
            "resident stream holding negative pages"
        assert self.free + sum(self.tables.values()) == self.n_pages, \
            "page leak: used + free != n_pages"


# ---------------------------------------------------------------------------
# transfer engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeasuredTransfer:
    """One REAL cross-device move observed by the executor (wall time
    around a ``jax.device_put`` + ``block_until_ready``), recorded next
    to the modeled ``TransferTiming`` log so measured and modeled
    transfer costs share one surface."""
    n_bytes: int
    seconds: float
    cross_node: bool
    kind: str                     # "migration" | "sp-expand" | "move"

    @property
    def bytes_per_s(self) -> float:
        return self.n_bytes / max(self.seconds, 1e-9)


@dataclasses.dataclass(frozen=True)
class TransferTiming:
    submitted: float
    first_layer_ready: float      # stream may re-enter the queue here
    complete: float               # all pages resident
    cross_node: bool
    bytes: int

    @property
    def total(self) -> float:
        return self.complete - self.submitted

    @property
    def residual_wait(self) -> float:
        """Time the dispatcher actually waited (protocol-dependent)."""
        return self.first_layer_ready - self.submitted


class AsyncTransferEngine:
    """Models SS4.4's NIXL/NCCL engine; one protocol for eviction,
    re-homing and elastic SP."""

    # blend of prior vs newest observed bandwidth when calibrating
    BW_EMA_DECAY = 0.5

    def __init__(self, *, protocol: str = "async-stream",
                 bw_intra: float = 200e9, bw_inter: float = 40e9,
                 overhead: float = 0.004, n_layers: int = 30,
                 calibrate: bool = True):
        assert protocol in ("sync", "async-nostream", "async-stream")
        self.protocol = protocol
        self.bw_intra = bw_intra
        self.bw_inter = bw_inter
        # the offline constants, kept for reporting once measurement
        # starts calibrating the live values
        self.bw_intra_model = bw_intra
        self.bw_inter_model = bw_inter
        self.overhead = overhead
        self.n_layers = n_layers
        self.calibrate = calibrate
        self.log: List[TransferTiming] = []
        self.measured: List[MeasuredTransfer] = []

    def record_measured(self, n_bytes: int, seconds: float, *,
                        cross_node: bool = False,
                        kind: str = "move") -> MeasuredTransfer:
        """Record one REAL device-to-device move (measured wall time)
        and, when ``calibrate``, fold its observed bytes/sec into the
        matching bandwidth constant (EMA) — so the *modeled* timelines
        of future ``transfer`` calls track this host's interconnect
        instead of the offline testbed constant."""
        m = MeasuredTransfer(n_bytes, seconds, cross_node, kind)
        self.measured.append(m)
        if self.calibrate and n_bytes > 0:
            obs = m.bytes_per_s
            if cross_node:
                self.bw_inter = (self.BW_EMA_DECAY * self.bw_inter
                                 + (1.0 - self.BW_EMA_DECAY) * obs) \
                    if len([x for x in self.measured
                            if x.cross_node]) > 1 else obs
            else:
                self.bw_intra = (self.BW_EMA_DECAY * self.bw_intra
                                 + (1.0 - self.BW_EMA_DECAY) * obs) \
                    if len([x for x in self.measured
                            if not x.cross_node]) > 1 else obs
        return m

    def measured_stats(self) -> Dict[str, float]:
        """Aggregate view of the measured-move log (the benchmark's
        ``transfer_measured`` block)."""
        n_bytes = sum(m.n_bytes for m in self.measured)
        seconds = sum(m.seconds for m in self.measured)
        return {
            "count": len(self.measured),
            "bytes": n_bytes,
            "seconds": round(seconds, 6),
            "bytes_per_s": round(n_bytes / seconds, 2) if seconds else 0.0,
            "bw_intra_calibrated": round(self.bw_intra, 2),
            "bw_intra_model": self.bw_intra_model,
        }

    def transfer(self, now: float, n_bytes: int, *,
                 cross_node: bool) -> TransferTiming:
        """Unified interface: returns the readiness timeline."""
        bw = self.bw_inter if cross_node else self.bw_intra
        total = self.overhead + n_bytes / bw
        per_layer = (n_bytes / self.n_layers) / bw
        if self.protocol == "async-stream":
            ready = now + self.overhead + per_layer
        else:
            ready = now + total          # sync / async-nostream wait fully
        t = TransferTiming(now, ready, now + total, cross_node, n_bytes)
        self.log.append(t)
        return t

    def blocks_dispatcher(self) -> bool:
        return self.protocol == "sync"
