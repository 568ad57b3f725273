"""Readings the check's limits are set from, and the knee sweep.

    python3 streambench/calibrate.py limits --workload sf-saturate \
        --seconds 10 --seeds 1,2,3 --control-seeds 4,5,6
    python3 streambench/calibrate.py sweep --workload sf-saturate \
        --seconds 45 --rates 0.04,0.06,0.08,0.1,0.2,0.4 --order-seeds 3,4,5
    python3 streambench/calibrate.py knee sweep-a.jsonl sweep-b.jsonl

``limits`` runs the cell's traffic once a seed in one process, at the
cell's load with a short window, and prints each seed's compared numbers:
sound runs first, then the control, which is the program with its own fp8
page path switched on for every chunk while the reference is told the
chunks are bfloat16 (a bfloat16-logged chunk over e4m3 pages).  ``sweep``
runs the cell's traffic at each rate under each order seed (each a
different arrival schedule and length order; ``--seed`` makes the weights
and the noise only) and prints the window's CPR, chunks a second, the
backlog at the window's close, the live-stream count at its start and end
and the process's host memory peak, then one line ``{"knee": K,
"plateau": P}`` by ``knee_plateau``'s rules; ``knee`` prints that line for
the sweep lines of the files it is given (a sweep and its finer steps
together).  None is part of a benchmark run.  One JSON line per run on
standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

ROOT = Path(__file__).resolve().parents[1]

CPR_KNEE = 0.9          # the least CPR a sustained rate keeps
BACKLOG_MAX = 1         # chunks due and not ready at the close: one is a
                        # stall, more a queue
FIRST_DUE_S = 1.5       # an unserved stream's first chunk is due two
                        # chunks of playout after its arrival
PLATEAU_NEAR = 0.05     # within this share of the sweep's best chunks a second


def backlog(streams, t: float, chunk_s: float) -> int:
    """Chunks due by ``t`` and not ready by then, one a stream at most: a
    started stream's next chunk by the playout rule, an unstarted one's
    first chunk ``FIRST_DUE_S`` after its arrival.  It grows with a queue,
    not with a stream that arrived just before ``t``."""
    from streambench.lib.playout import deadlines
    n = 0
    for s in streams:
        if s.arrival > t or s.refused:
            continue
        ready = [r for r in s.ready if r <= t]
        if len(ready) >= s.target:
            continue
        if not ready:
            n += t - s.arrival > FIRST_DUE_S
            continue
        _, nxt = deadlines(ready, chunk_s)
        n += nxt < t
    return n


def sustained(point: Dict) -> bool:
    """A sweep point whose window kept CPR at or above ``CPR_KNEE``, closed
    with at most ``BACKLOG_MAX`` chunks due and not ready, failed no chunk,
    and ran to the window's end."""
    return (not point.get("stopped") and point.get("cpr", 0.0) >= CPR_KNEE
            and point.get("backlog", BACKLOG_MAX + 1) <= BACKLOG_MAX
            and point.get("failed", 1) == 0)


def knee_plateau(points: Iterable[Dict]) -> Dict[str, Optional[float]]:
    """The knee: the highest swept rate at or below which every point of
    every swept rate is ``sustained``.  The plateau: the lowest swept rate
    whose chunks a second, the mean over its points, is within
    ``PLATEAU_NEAR`` of the highest such mean in the sweep.  A point that
    stopped before the window closed has no chunks a second and counts only
    against the knee."""
    by_rate: Dict[float, list] = {}
    for p in points:
        by_rate.setdefault(float(p["rate"]), []).append(p)
    knee = None
    for r in sorted(by_rate):
        if not all(sustained(p) for p in by_rate[r]):
            break
        knee = r
    mean = {}
    for r, ps in by_rate.items():
        rates = [p["chunks_per_s"] for p in ps if "chunks_per_s" in p]
        if rates:
            mean[r] = sum(rates) / len(rates)
    top = max(mean.values(), default=None)
    plateau = None if top is None else min(
        r for r, m in mean.items() if m >= (1.0 - PLATEAU_NEAR) * top)
    return {"knee": knee, "plateau": plateau}


class HostPeak:
    """The process's resident-set peak while it is entered, sampled every
    half second from ``/proc/self/status``."""

    def __enter__(self):
        import threading
        self.peak, self._stop = 0, threading.Event()
        self._t = threading.Thread(target=self._sample, daemon=True)
        self._t.start()
        return self

    def _sample(self):
        while True:
            for line in Path("/proc/self/status").read_text().splitlines():
                if line.startswith("VmRSS:"):
                    self.peak = max(self.peak, int(line.split()[1]) * 1024)
            if self._stop.wait(0.5):
                return

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()


def fp8_pages(session) -> None:
    """Every chunk the policy picks, served over e4m3 pages."""
    inner = session.control.fidelity_policy

    class Forced:
        def select(self, budget):
            d = inner.select(budget)
            return dataclasses.replace(
                d, fidelity=d.fidelity._replace(quant="fp8"))

    session.control.fidelity_policy = Forced()


def one(cell, seed: int, seconds: float, control: bool = False):
    from streambench.lib import playout, serve, traffic
    arrivals = traffic.arrivals(cell.traffic, seconds)
    t = time.perf_counter()
    rec = serve.run_window(cell.config, arrivals, seed=seed,
                           ramp_s=float(cell.traffic["ramp_s"]),
                           seconds=seconds, trace=False, device="cuda",
                           t_process=t,
                           session_hook=fp8_pages if control else None)
    play = playout.playout(rec.streams, rec.window, traffic.CHUNK_SECONDS)
    out = {"seed": seed, "control": control, "setup_s": rec.setup_s,
           "memory_peak": rec.memory_peak,
           **playout.summary(play, rec.window)}
    times = [rec.window.start, rec.window.end]
    out["live"] = playout.live_counts(rec.streams, times)
    out["backlog"] = backlog(rec.streams, rec.window.end,
                             traffic.CHUNK_SECONDS)
    return rec, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("limits", "sweep", "knee"))
    ap.add_argument("files", nargs="*", help="knee: files of sweep lines")
    ap.add_argument("--workload")
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seed", type=int, default=1,
                    help="sweep: the weights' and the noise's seed")
    ap.add_argument("--order-seeds", default="",
                    help="sweep: arrival orders (default: the cell's own)")
    args = ap.parse_args()
    if args.mode == "knee":
        points = [json.loads(line) for f in args.files
                  for line in Path(f).read_text().splitlines()
                  if line.startswith("{") and '"rate"' in line]
        print(json.dumps(knee_plateau(points)))
        return 0
    if args.workload is None or args.seconds is None:
        ap.error("limits and sweep take --workload and --seconds")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from streambench.run import fixed_caches
    fixed_caches()
    from streambench.lib import bench, check
    cell = bench.cell(ROOT, args.workload)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    if args.mode == "sweep":
        points = []
        orders = ints(args.order_seeds) or [int(cell.traffic["order_seed"])]
        for rate in [float(x) for x in args.rates.split(",")]:
            for order in orders:
                c = dataclasses.replace(cell, traffic=dict(
                    cell.traffic, rate=rate, order_seed=order))
                head = {"rate": rate, "order_seed": order, "seed": args.seed}
                try:
                    with HostPeak() as host:
                        rec, out = one(c, args.seed, args.seconds)
                except RuntimeError as e:
                    if "ran out of work" not in str(e):
                        raise
                    # the session's loop returned before the window closed
                    point = dict(head, stopped=str(e))
                    points.append(point)
                    print(json.dumps(point), flush=True)
                    continue
                out["host_peak_bytes"] = host.peak
                out["streams"] = [[s.arrival, s.target, s.ready]
                                  for s in rec.streams]
                out["fidelities"] = sorted(
                    (k, sum(s.keys.count(k) for s in rec.streams))
                    for k in {k for s in rec.streams for k in s.keys})
                points.append(dict(out, **head))
                print(json.dumps(points[-1]), flush=True)
                del rec
        print(json.dumps(knee_plateau(points)), flush=True)
        return 0
    runs = [(s, False) for s in ints(args.seeds)] + \
        [(s, True) for s in ints(args.control_seeds)]
    for seed, control in runs:
        rec, out = one(cell, seed, args.seconds, control)
        keys_of = None
        if control:
            keys_of = {s.sid: [k.replace("_fp8", "_bf16") for k in s.keys]
                       for s in rec.streams}
        t = time.perf_counter()
        res = check.check(rec, cell.config, seed, "cuda", keys_of=keys_of)
        out["check_s"] = time.perf_counter() - t
        out["checks"] = {k: v["value"] for k, v in res.items()}
        out["gaps"] = res["chunk_gap"]["each"]
        out["page_gaps"] = res["kv_page_gap"]["each"]
        print(json.dumps(out), flush=True)
        del rec
    return 0


if __name__ == "__main__":
    sys.exit(main())
