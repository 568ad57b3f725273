"""The program's own tracer (``repro_torch.profiler.trace``) over a cell's
window, beside the benchmark's profile; not part of a run, and the
check that decides ``correct`` is not made.

    python3 streambench/program_trace.py --workload sf-saturate \
        --seed 7 --seconds 45 --mode traced --out trace.json

``--mode traced``: the window under ``torch.profiler``, as ``run.py
--trace 1`` runs it, with the program's tracer started and stopped with
the profiler.  It gives the three readings of the program's record
(``segment_share``, ``split_launch_share``, ``queue_wait_share``, the
functions below), kernel 1's profiled time inside the program's
``device.attn.context`` spans and how far apart the two clocks place
them, the idle device time inside program spans, the idle gaps named by
the innermost program span open at their middle, the window's host and
device time by span, and the rounds, launches and chunk records behind
the readings.

``--mode on`` / ``--mode off``: the window untraced, with the program's
tracer on from the window's start to the stop, or off; the end-to-end
metrics and the number of spans recorded (the tracer's cost).

``--mode spans``: host microseconds a span and a device span cost,
tracing off and on.

``--mode clock``: spin kernels on the idle card, each in a device span,
under the profiler as the harness starts it: each kernel's start as the
profiler places it and its span's start as the program places it,
against the host's read just before the kernel's launch.

The last line of standard output is one JSON object, also written to
``--out`` when given.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Sequence, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


# ---- readings of the program's record ---------------------------------------

def _total(spans, name: str) -> float:
    return sum(s.end - s.start for s in spans if s.name == name)


def segment_share(prog) -> Optional[float]:
    """In-chunk segment's device time over the model step's, in %."""
    step = _total(prog.device_spans, "device.step")
    if step <= 0.0:
        return None
    return 100.0 * _total(prog.device_spans, "device.attn.chunk") / step


def split_launch_share(prog) -> Optional[float]:
    """Launches beyond a round's first over all launches, in %."""
    n = prog.counters.get("launches", 0)
    if not n:
        return None
    return 100.0 * prog.counters.get("split_launches", 0) / n


def queue_wait_share(prog, lo: float = float("-inf"),
                     hi: float = float("inf")) -> Optional[float]:
    """Of the time from runnable to ready of the chunks ready in [lo, hi)
    (host clock), the share spent in no step, in %."""
    chunks = [c for c in prog.chunks if lo <= c["ready"] < hi]
    span = sum(c["ready"] - c["runnable"] for c in chunks)
    if span <= 0.0:
        return None
    return 100.0 * sum(c["ready"] - c["runnable"] - c["active_s"]
                       for c in chunks) / span


# ---- the traced window ------------------------------------------------------

def _quantiles(xs: Sequence[float]) -> Dict[str, float]:
    xs = sorted(xs)
    if not xs:
        return {}
    pick = lambda q: xs[min(len(xs) - 1, int(q * len(xs)))]  # noqa: E731
    return {"n": len(xs), "min": xs[0], "p01": pick(0.01),
            "median": statistics.median(xs), "p99": pick(0.99),
            "max": xs[-1]}


def _union(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _overlap(a: float, b: float, merged, starts) -> float:
    """Length of [a, b] inside the sorted disjoint intervals ``merged``."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0.0
    while i < len(merged) and merged[i][0] < b:
        got += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return got


def _nearest(mids: List[float], m: float) -> int:
    i = bisect.bisect_left(mids, m)
    return min((j for j in (i - 1, i) if 0 <= j < len(mids)),
               key=lambda j: abs(mids[j] - m))


def _stretch_medians(at: List[float], ys: List[float],
                     bin_s: float) -> Dict[float, float]:
    bins: Dict[int, List[float]] = collections.defaultdict(list)
    for x, y in zip(at, ys):
        bins[int(x // bin_s)].append(y)
    return {k * bin_s: statistics.median(v) for k, v in sorted(bins.items())}


def against(kernels: List[Tuple[float, float]],
            spans: List[Tuple[float, float]], t0: float,
            bin_s: float = 5.0) -> Dict:
    """Kernels (sorted) against the spans that should hold them, each
    paired with the span whose middle is nearest its own: the share of
    kernel time inside the spans; how far a kernel starts after its
    span's start (``lead``, median over ``bin_s`` stretches from ``t0``)
    and ends before its end; and the share inside after one shift of the
    kernels per stretch, the one that centers them in their spans."""
    if not kernels or not spans:
        return {"kernels": len(kernels), "spans": len(spans)}
    starts = [s for s, _ in spans]
    mids = [0.5 * (s + t) for s, t in spans]
    total = sum(b - a for a, b in kernels)
    lead, trail, off, at = [], [], [], []
    for a, b in kernels:
        i = _nearest(mids, 0.5 * (a + b))
        lead.append(1e6 * (a - spans[i][0]))
        trail.append(1e6 * (spans[i][1] - b))
        off.append(0.5 * (a + b) - mids[i])
        at.append(a - t0)
    shift = _stretch_medians(at, off, bin_s)
    moved = [(a - shift[(x // bin_s) * bin_s], b - shift[(x // bin_s)
                                                          * bin_s])
             for (a, b), x in zip(kernels, at)]
    return {
        "kernels": len(kernels), "spans": len(spans),
        "inside_share": 100.0 * sum(_overlap(a, b, spans, starts)
                                    for a, b in kernels) / total,
        "lead_us": _quantiles(lead), "trail_us": _quantiles(trail),
        "lead_median_us_by_stretch": _stretch_medians(at, lead, bin_s),
        "inside_share_realigned": 100.0 * sum(
            _overlap(a, b, spans, starts) for a, b in moved) / total,
        "shift_us_by_stretch": {k: 1e6 * v for k, v in shift.items()}}


def analyse(dt, prog) -> Dict:
    """The program's record against the profiler's window ``dt`` (a
    ``lib.trace.DeviceTrace`` before ``reduce`` drops its profile)."""
    import torch

    from repro_torch.profiler import trace as ptrace
    evs = [e for e in dt.prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    marker = next((e for e in evs if "sleep" in e.name.lower()
                   or "spin" in e.name.lower()), evs[0] if evs else None)
    offset = (dt.t_mark - marker.time_range.start * 1e-6
              if marker is not None else 0.0)
    lo, hi = dt.t_start, dt.t_end
    kernels, k1 = [], []
    for e in evs:
        if e is marker:
            continue
        s = max(e.time_range.start * 1e-6 + offset, lo)
        t = min(e.time_range.end * 1e-6 + offset, hi)
        if t > s:
            kernels.append((s, t))
            if "paged_chunk_attention" in e.name:
                k1.append((s, t))

    # kernel 1 against the program's device.attn.context spans, and the
    # card's clock against the host's
    ctx = sorted((s.start, s.end) for s in prog.device_spans
                 if s.name == "device.attn.context")
    clock = next(iter(prog.clock.values()), [])
    drift_ppm = (1e6 * ((clock[-1][1] - clock[0][1]) - clock[-1][0])
                 / clock[-1][0] if len(clock) > 1 else None)

    # idle device time, and the program's spans over it
    busy = _union(kernels)
    gaps, cur = [], lo
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        gaps.append((cur, hi))
    host = _union([(s.start, s.end) for s in prog.spans if s.parent < 0])
    host_starts = [s for s, _ in host]
    idle = sum(b - a for a, b in gaps)
    idle_in_program = sum(_overlap(a, b, host, host_starts)
                          for a, b in gaps)
    at = ptrace.labeller(prog.spans)
    by_label: collections.Counter = collections.Counter()
    labelled = []
    for a, b in gaps:
        sp = at(0.5 * (a + b))
        name = sp.name if sp is not None else "outside every program span"
        by_label[name] += b - a
        labelled.append((name, b - a))
    labelled.sort(key=lambda g: -g[1])

    # host self time and device time by span, in the window
    child: collections.Counter = collections.Counter()
    for s in prog.spans:
        if s.parent >= 0:
            child[s.parent] += s.end - s.start
    host_self: collections.Counter = collections.Counter()
    host_n: collections.Counter = collections.Counter()
    for i, s in enumerate(prog.spans):
        host_self[s.name] += (s.end - s.start) - child[i]
        host_n[s.name] += 1
    device: collections.Counter = collections.Counter()
    for s in prog.device_spans:
        device[s.name] += s.end - s.start

    # rounds, launches and chunks
    rounds = [s.attrs for s in prog.spans if s.name == "session.round"]
    steps = [s.attrs for s in prog.spans if s.name == "executor.run_step"
             and s.attrs.get("launched")]
    per_tier: Dict[str, List[float]] = collections.defaultdict(list)
    for c in prog.chunks:
        per_tier[str(c["tier"])].append(c["ready"] - c["runnable"]
                                   - c["active_s"])
    by_fid: Dict[str, List[float]] = collections.defaultdict(list)
    for c in prog.chunks:
        if c["budget"] is not None:     # begun before tracing started
            by_fid[c["fidelity"]].append(c["budget"])
    begins = [s.attrs for s in prog.spans if s.name == "session.begin_chunk"]
    return {
        "segment_share": segment_share(prog),
        "split_launch_share": split_launch_share(prog),
        "queue_wait_share": queue_wait_share(prog),
        "counters": dict(prog.counters),
        "kernel1_s": sum(t - s for s, t in k1),
        "kernel1_in_context": against(sorted(k1), ctx, lo),
        "clock_anchors": len(clock), "clock_drift_ppm": drift_ppm,
        "clock_anchor_width_us": _quantiles([1e6 * w for *_, w in clock]),
        "window_s": hi - lo, "busy_s": sum(t - s for s, t in busy),
        "idle_s": idle, "idle_in_program_share": (
            100.0 * idle_in_program / idle if idle else None),
        "idle_by_span": dict(by_label.most_common()),
        "longest_gaps": labelled[:10],
        "host_self_s": dict(host_self.most_common()),
        "host_spans": dict(host_n),
        "device_s": dict(device.most_common()),
        "rounds": {
            "runnable": dict(collections.Counter(
                sum(r["runnable"]) for r in rounds)),
            "admitted": dict(collections.Counter(
                sum(r["admitted"]) for r in rounds)),
            "launches": dict(collections.Counter(
                r["launches"] for r in rounds))},
        "launch_rows": dict(collections.Counter(s["rows"] for s in steps)),
        "launch_dtypes": dict(collections.Counter(
            "+".join(sorted({k.rsplit("_", 1)[1] for k in s["keys"]}))
            for s in steps)),
        "queue_wait_s_by_tier": {k: _quantiles(v)
                                 for k, v in per_tier.items()},
        "budget_s_by_fidelity": {k: _quantiles(v)
                                 for k, v in by_fid.items()},
        "choices": [(b["tier"], round(b["budget"], 4), b["fidelity"],
                     round(b["predicted"], 4)) for b in begins],
    }


def _window(cell, args, *, trace: bool, hook=None):
    from streambench.lib import serve, traffic
    arrivals = traffic.arrivals(cell.traffic, args.seconds)
    return serve.run_window(cell.config, arrivals, seed=args.seed,
                            ramp_s=float(cell.traffic["ramp_s"]),
                            seconds=args.seconds, trace=trace,
                            device="cuda", t_process=T_PROCESS,
                            session_hook=hook)


def _end_to_end(cell, rec) -> Dict:
    from streambench.lib import bench, playout, traffic
    from streambench.lib.context import Ctx
    play = playout.playout(rec.streams, rec.window, traffic.CHUNK_SECONDS)
    ctx = Ctx(cell.name, cell.config, rec, play,
              playout.summary(play, rec.window), rec.trace)
    out = {k: v["value"]
           for k, v in bench.read_metrics(cell.end_to_end, ctx).items()}
    out["setup_s"] = rec.setup_s
    return out


def traced(cell, args) -> Dict:
    from repro_torch.profiler import trace as ptrace
    from streambench.lib import trace as T

    class WithProgram(T.DeviceTrace):
        # the program's tracer brackets the profiler's window, so that
        # its anchoring and its stop fall outside the window
        def start(self):
            ptrace.start()
            super().start()

        def stop(self):
            super().stop()
            self.program = ptrace.stop()

        def reduce(self, spans):
            out = super().reduce(spans)
            out["program"] = analyse(self, self.program)
            return out

    T.DeviceTrace = WithProgram
    rec = _window(cell, args, trace=True)
    return dict(rec.trace["program"], harness_idle_gaps=rec.trace[
        "longest_gaps"], end_to_end=_end_to_end(cell, rec))


def tracer_cost(cell, args, on: bool) -> Dict:
    from repro_torch.profiler import trace as ptrace
    ramp_s = float(cell.traffic["ramp_s"])

    def hook(session):
        tick = session.control.tick

        def at_window(view, now):
            if on and now >= ramp_s and ptrace.active() is None:
                ptrace.start()
            return tick(view, now)
        session.control.tick = at_window

    rec = _window(cell, args, trace=False, hook=hook)
    prog = ptrace.stop()
    out = _end_to_end(cell, rec)
    out["tracer"] = "on" if on else "off"
    if prog is not None:
        out["spans"] = len(prog.spans)
        out["device_spans"] = len(prog.device_spans)
    return out


def _after(times: List[float], t_ref: List[float], t0: float,
           bin_s: float = 5.0) -> Dict[float, float]:
    """Median of ``times - t_ref`` (us) over ``bin_s`` stretches."""
    return _stretch_medians([r - t0 for r in t_ref],
                            [1e6 * (t - r) for t, r in zip(times, t_ref)],
                            bin_s)


def clock(n: int = 900) -> Dict:
    """``n`` spin kernels of about a millisecond, 50 ms apart on an idle
    card, each in a device span, under the profiler as the harness starts
    it, with an anchor every 20: each kernel as the profiler places it
    against its span as the program places it (from all anchors, and from
    the first alone), and both against the host's read just before the
    kernel's launch."""
    import torch

    from repro_torch.profiler import trace as ptrace
    from streambench.lib import trace as T
    dev = torch.device("cuda")
    dt = T.DeviceTrace()
    dt.prime()
    ptrace.start()
    dt.start()
    launched = []
    for i in range(n):
        with ptrace.device_span("spin", dev):
            launched.append(time.perf_counter())
            torch.cuda._sleep(2_000_000)
        time.sleep(0.05)
        if i % 20 == 19:
            torch.cuda.synchronize()
            ptrace.synced(dev)
    dt.stop()
    prog = ptrace.stop()
    evs = sorted((e for e in dt.prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    marker = evs[0]
    offset = dt.t_mark - marker.time_range.start * 1e-6
    kernels = [(e.time_range.start * 1e-6 + offset,
                e.time_range.end * 1e-6 + offset) for e in evs[1:]]
    spans = sorted((s.start, s.end) for s in prog.device_spans)
    clk = next(iter(prog.clock.values()))
    return {"marker": marker.name, "anchors": len(clk),
            "drift_ppm": 1e6 * ((clk[-1][1] - clk[0][1]) - clk[-1][0])
            / clk[-1][0],
            "anchor_width_us": _quantiles([1e6 * w for *_, w in clk]),
            "kernels_in_spans": against(kernels, spans, dt.t_start),
            "profiler_start_after_launch_us": _after(
                [a for a, _ in kernels], launched, dt.t_start),
            "span_start_after_launch_us": _after(
                [a for a, _ in spans], launched, dt.t_start)}


def span_cost(n: int = 200_000) -> Dict:
    import torch

    from repro_torch.profiler import trace as ptrace
    dev = torch.device("cuda")
    torch.ones(1, device=dev)

    def per_call(body, reps):
        t = time.perf_counter()
        for _ in range(reps):
            body()
        return 1e6 * (time.perf_counter() - t) / reps

    def host():
        with ptrace.span("x"):
            pass

    def device():
        with ptrace.device_span("x", dev):
            pass

    out = {"off": {"span": per_call(host, n),
                   "device_span": per_call(device, n)}}
    ptrace.start()
    out["on"] = {"span": per_call(host, n),
                 "device_span": per_call(device, n // 10)}
    t = time.perf_counter()
    rec = ptrace.stop()
    out["on"]["stop_us_per_device_span"] = (
        1e6 * (time.perf_counter() - t) / len(rec.device_spans))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="sf-saturate")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--mode", choices=("traced", "on", "off", "spans",
                                       "clock"),
                    default="traced")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from streambench import run as R
    R.fixed_caches()
    import torch
    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA device", file=sys.stderr)
        return 3
    from streambench.lib import bench
    cell = bench.cell(ROOT, args.workload)
    if args.mode == "spans":
        out = span_cost()
    elif args.mode == "clock":
        out = clock()
    elif args.mode == "traced":
        out = traced(cell, args)
    else:
        out = tracer_cost(cell, args, on=args.mode == "on")
    out.update(workload=args.workload, seed=args.seed, mode=args.mode,
               device=torch.cuda.get_device_name())
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
