"""Readings the check's limits are set from, and the knee sweep.

    python3 streambench/calibrate.py limits --workload sf-overload \
        --seconds 10 --seeds 1,2,3 --control-seeds 4,5,6
    python3 streambench/calibrate.py sweep --workload sf-overload \
        --seconds 30 --rates 0.15,0.2,0.25 --seed 9

``limits`` runs the cell's traffic once a seed in one process, at the
cell's load with a short window, and prints each seed's compared numbers:
sound runs first, then the control, which is the program with its own fp8
page path switched on for every chunk while the reference is told the
chunks are bfloat16 (a bfloat16-logged chunk over e4m3 pages).  ``sweep``
runs the cell's traffic at each rate and prints the window's CPR, chunks
a second and the live-stream count at the window's start and end.  Neither
is part of a benchmark run.  One JSON line per run on standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
    return rec, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("limits", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seed", default="1")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from streambench.run import fixed_caches
    fixed_caches()
    from streambench.lib import bench, check
    cell = bench.cell(ROOT, args.workload)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    if args.mode == "sweep":
        for rate in [float(x) for x in args.rates.split(",")]:
            c = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                       rate=rate))
            for seed in ints(args.seed):
                rec, out = one(c, seed, args.seconds)
                out["streams"] = [[s.arrival, s.target, s.ready]
                                  for s in rec.streams]
                out["fidelities"] = sorted(
                    (k, sum(s.keys.count(k) for s in rec.streams))
                    for k in {k for s in rec.streams for k in s.keys})
                print(json.dumps(dict(out, rate=rate)), flush=True)
                del rec
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
