"""Run one cell of the benchmark and print its result line.

    python3 streambench/run.py --workload sf-saturate --seed 7 --seconds 45 \
        --trace 0

From the root of a checkout on a machine with the cell's cards.  Set-up
(weights from the seed on the card, the pool, the session's calibration
chunk, a warm-up of every batch shape) counts as ``setup_s``; then a ramp of
arrivals, the measured window, the stop, and the check of what the window
served against the plain reference.  The last line of standard output is
one JSON object; the numbers the check compared, each with its limit, are
the last lines of standard error.  ``--trace 1`` reports the per-layer
metrics from a ``torch.profiler`` trace of the window instead of the
end-to-end ones.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE = ROOT / ".benchcache"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fixed_caches() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a checkout's first run builds."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run(args, *, device="cuda", cell=None, session_hook=None,
        t_process: float = T_PROCESS):
    """Drive one run; returns (result dict, checks).  ``device``, ``cell``
    (a ``bench.Cell`` in place of the workload's) and ``session_hook``
    serve the tests, which run on the CPU."""
    import torch

    from streambench.lib import bench, check, playout, serve, traffic
    from streambench.lib.context import Ctx

    c = cell or bench.cell(ROOT, args.workload)
    cfg = c.config
    arrivals = traffic.arrivals(c.traffic, args.seconds)
    rec = serve.run_window(cfg, arrivals, seed=args.seed,
                           ramp_s=float(c.traffic["ramp_s"]),
                           seconds=args.seconds, trace=bool(args.trace),
                           device=device, t_process=t_process,
                           session_hook=session_hook)
    t_win = time.perf_counter()
    play = playout.playout(rec.streams, rec.window, traffic.CHUNK_SECONDS)
    ctx = Ctx(c.name, cfg, rec, play, playout.summary(play, rec.window),
              rec.trace)
    metrics = bench.read_metrics(c.per_layer if args.trace else c.end_to_end,
                                 ctx)
    t_check = time.perf_counter()
    checks = check.check(rec, cfg, args.seed, device)
    print(f"streambench: set-up {rec.setup_s:.1f} s, window closed at "
          f"{rec.window.stop:.2f} s of session time, metrics "
          f"{t_check - t_win:.1f} s, check {time.perf_counter() - t_check:.1f}"
          f" s, chunk gaps {checks['chunk_gap']['each']}, page gaps "
          f"{checks['kv_page_gap']['each']}", file=sys.stderr)
    dev = torch.device(device)
    result = {
        "correct": all(v["ok"] for v in checks.values()),
        "attempted": play.due,
        "failed": play.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": c.chips,
            "memory_peak_bytes": rec.memory_peak,
        },
    }
    if rec.trace is not None:
        t = rec.trace
        result["device"]["busy_s"] = t["busy_s"]
        result["device"]["window_s"] = t["window_s"]
        cats = sorted(t["by_category"].items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in cats[:10]],
            "idle_gaps": [[k, v] for k, v in t["longest_gaps"]]}
    result["window"] = dict(ctx.summary, fidelities=dict(
        collections.Counter(play.keys_in_window)), **rec.counters)
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    fixed_caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from streambench.lib import bench
    chips = bench.cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"streambench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    result, checks = run(args)
    bad = forbidden_modules()
    if bad:
        print(f"streambench: loaded modules of {bad}: the run measures the "
              "PyTorch port only", file=sys.stderr)
        return 4
    for name, v in checks.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
