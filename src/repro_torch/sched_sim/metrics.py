"""Evaluation metrics (paper SS7.1) — ONE metrics surface for simulated
and real runs.

    QoE = CPR = mean over streams of (fraction of chunks ready by their
          playout deadlines)
    TTFC = mean time from arrival to first playable chunk
    quality = mean profiled VBench over all delivered chunks
    stalls = per-stream count + duration distribution (Fig. 14)

Every function here is duck-typed over a *result-like* object — the
discrete-event simulator's ``SimResult`` or the real executor's
``serve.session.SessionResult``.  Both expose ``streams`` (sid ->
``core.types.Stream`` record), an ``engine`` transfer log, and the
rehoming / elastic-SP counters, so the same ``StreamSpec`` workload run
through either loop yields ``Summary`` objects with identically
defined fields (apples-to-apples sim-vs-real comparison).
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List


@dataclasses.dataclass(frozen=True)
class Summary:
    qoe: float
    ttfc: float
    quality: float
    stalls_per_stream: float
    avg_stall_ms: float
    n_streams: int
    n_chunks: int
    n_rehomings: int
    n_sp_events: int
    n_unserved: int = 0           # admitted streams with zero ready chunks
    avg_effective_window: float = 0.0   # mean page-degraded KV window
    # heterogeneous co-serving: per-model rows (model name -> {cpr,
    # ttfc, n_streams, n_chunks, streams_per_s}) so sim-vs-real parity
    # holds per model, not just in aggregate; empty when no stream
    # carries a model tag (single-model runs)
    by_model: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def row(self) -> str:
        return (f"QoE={self.qoe:.3f} TTFC={self.ttfc:.2f}s "
                f"VBench={self.quality:.2f} "
                f"stalls/stream={self.stalls_per_stream:.2f} "
                f"avg_stall={self.avg_stall_ms:.0f}ms")

    def model_rows(self) -> List[str]:
        return [f"  [{m}] CPR={r['cpr']:.3f} TTFC={r['ttfc']:.2f}s "
                f"streams={r['n_streams']:.0f} chunks={r['n_chunks']:.0f} "
                f"streams/s={r['streams_per_s']:.3f}"
                for m, r in sorted(self.by_model.items())]


def summarize(res: Any) -> Summary:
    """CPR / TTFC / quality / stall summary of a result-like object
    (``SimResult`` or ``SessionResult`` — see module docstring).

    An admitted stream with NO ready chunks (overload, ``max_time``
    truncation — exactly the regimes admission control creates) counts
    as CPR 0 and is reported in ``n_unserved``: it received the worst
    possible experience, so skipping it would silently inflate QoE and
    deflate ``n_streams``.  TTFC stays a served-streams mean (an
    unserved stream has no finite first-chunk time to average)."""
    cprs: List[float] = []
    ttfcs: List[float] = []
    quals: List[float] = []
    stall_counts: List[int] = []
    stall_durs: List[float] = []
    n_chunks = 0
    n_unserved = 0
    for s in res.streams.values():
        if not s.ready_times:
            n_unserved += 1
            cprs.append(0.0)               # admitted, never served: CPR 0
            stall_counts.append(0)
            continue
        hits = sum(1 for r, d in zip(s.ready_times, s.deadlines) if r <= d)
        cprs.append(hits / max(len(s.ready_times), 1))
        if s.first_chunk_time is not None:
            ttfcs.append(s.first_chunk_time - s.arrival)
        quals.extend(s.qualities)
        stall_counts.append(len(s.stall_events))
        stall_durs.extend(s.stall_events)
        n_chunks += len(s.ready_times)
    return Summary(
        qoe=statistics.mean(cprs) if cprs else 0.0,
        ttfc=statistics.mean(ttfcs) if ttfcs else float("inf"),
        quality=statistics.mean(quals) if quals else 0.0,
        stalls_per_stream=statistics.mean(stall_counts) if stall_counts
        else 0.0,
        avg_stall_ms=1000.0 * statistics.mean(stall_durs) if stall_durs
        else 0.0,
        n_streams=len(cprs), n_chunks=n_chunks,
        n_rehomings=getattr(res, "n_rehomings", 0),
        n_sp_events=getattr(res, "n_sp_events", 0),
        n_unserved=n_unserved,
        avg_effective_window=_avg_effective_window(res),
        by_model=_by_model(res))


def _by_model(res: Any) -> Dict[str, Dict[str, float]]:
    """Per-model CPR/TTFC/streams-per-s rows (heterogeneous co-serving).
    Empty unless at least one stream record carries a model tag, so
    single-model summaries are unchanged."""
    groups: Dict[str, List[Any]] = {}
    for s in res.streams.values():
        m = getattr(s, "model", None)
        if m is not None:
            groups.setdefault(m, []).append(s)
    rows: Dict[str, Dict[str, float]] = {}
    for m, streams in sorted(groups.items()):
        cprs, ttfcs = [], []
        n_chunks = 0
        served = [s for s in streams if s.ready_times]
        for s in streams:
            if not s.ready_times:
                cprs.append(0.0)
                continue
            hits = sum(1 for r, d in zip(s.ready_times, s.deadlines)
                       if r <= d)
            cprs.append(hits / max(len(s.ready_times), 1))
            if s.first_chunk_time is not None:
                ttfcs.append(s.first_chunk_time - s.arrival)
            n_chunks += len(s.ready_times)
        span = (max(s.ready_times[-1] for s in served)
                - min(s.arrival for s in streams)) if served else 0.0
        rows[m] = {
            "cpr": statistics.mean(cprs) if cprs else 0.0,
            "ttfc": statistics.mean(ttfcs) if ttfcs else float("inf"),
            "n_streams": float(len(streams)),
            "n_chunks": float(n_chunks),
            "streams_per_s": (len(served) / span if span > 0 else 0.0),
        }
    return rows


def _avg_effective_window(res: Any) -> float:
    """Mean of per-stream mean effective (page-degraded) KV windows.
    Real runs attach ``effective_window`` (sid -> per-launch window
    history); simulated results lack it and report 0."""
    logs = getattr(res, "effective_window", None) or {}
    per_stream = [statistics.mean(log) for log in logs.values() if log]
    return statistics.mean(per_stream) if per_stream else 0.0


def stall_histogram(res: Any,
                    edges=(0.1, 0.25, 0.5, 1.0, 2.0, 5.0)) -> Dict[str, int]:
    durs = [d for s in res.streams.values() for d in s.stall_events]
    hist: Dict[str, int] = {}
    lo = 0.0
    for e in edges:
        hist[f"{lo:.2f}-{e:.2f}s"] = sum(1 for d in durs if lo <= d < e)
        lo = e
    hist[f">{edges[-1]:.2f}s"] = sum(1 for d in durs if d >= edges[-1])
    return hist


def transfer_stats(res: Any) -> Dict[str, float]:
    log = res.engine.log
    if not log:
        return {"n": 0, "avg_ms": 0.0, "p95_ms": 0.0,
                "avg_residual_ms": 0.0, "p95_residual_ms": 0.0}
    totals = sorted(t.total for t in log)
    waits = sorted(t.residual_wait for t in log)

    def p95(xs):
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]
    return {"n": len(log),
            "avg_ms": 1000 * statistics.mean(totals),
            "p95_ms": 1000 * p95(totals),
            "avg_residual_ms": 1000 * statistics.mean(waits),
            "p95_residual_ms": 1000 * p95(waits)}
