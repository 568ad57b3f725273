"""Multi-pod dry-run on the CPU, a port of the JAX reference's
``launch/dryrun.py``.

For every (architecture x input shape x mesh) cell: set up a fake
process group of 256 or 512 ranks (``lowering.fake_world``), build the
production mesh over it, trace the sharded step once on fake stand-ins
(``lowering.lower_cell``) and record rank 0's FLOPs, bytes, collective
bytes, argument bytes and the H100 roofline (``launch/analysis.py``).
Success proves the distribution config is coherent: every op of the
step has a sharding rule or runs per shard.  The fake group lives only
inside ``run_cell``, so no default group leaks into the caller.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \\
        --shape train_4k [--multi-pod] [--windowed-adaptation]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--jobs N]

``--jobs N`` runs N cells at a time, each in a process of its own (a
cell's trace is single-threaded Python: a prefill_32k cell of a large
model dispatches millions of fake ops and takes many minutes).

Artifacts: ``dryrun_artifacts/<arch>__<shape>__<mesh>.json`` at the
root of the checkout (git-ignored); ``--no-save`` writes none.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.launch import analysis
from repro_torch.launch.lowering import cell_config, fake_world, lower_cell
from repro_torch.launch.mesh import make_production_mesh

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "dryrun_artifacts")


def _save(tag: str, rec: dict) -> None:
    os.makedirs(ART_DIR, exist_ok=True)
    with open(os.path.join(ART_DIR, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             windowed_adaptation: bool = False, verbose: bool = True,
             save: bool = True, analyze: bool = True) -> dict:
    """One dry-run cell.  ``analyze=False`` skips the roofline terms
    (trace success + argument bytes only)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}" + \
        ("__winadapt" if windowed_adaptation else "")
    if not windowed_adaptation and not cfg.supports_shape(shape):
        rec = {"cell": tag, "status": "skipped",
               "reason": "long_500k needs sub-quadratic attention "
                         "(DESIGN.md SS4); windowed adaptation lowered "
                         "separately"}
        if save:
            _save(tag, rec)
        if verbose:
            print(json.dumps(rec))
        return rec

    n_chips = 512 if multi_pod else 256
    t0 = time.time()
    try:
        with fake_world(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            lowered = lower_cell(cfg, mesh, shape,
                                 windowed_adaptation=windowed_adaptation)
        # no compile step: the traced call is the lowering
        rec = {"cell": tag, "status": "ok", "n_chips": n_chips,
               "lower_s": round(time.time() - t0, 1), "compile_s": None}
        mf = analysis.model_flops(cell_config(
            cfg, shape, windowed_adaptation=windowed_adaptation), shape)
        rec["model_flops"] = mf
        if analyze:
            roof = analysis.analyze(lowered, n_chips)
            rec.update(roof.row())
            rec["coll_by_op"] = roof.coll_by_op
            rec["useful_ratio"] = (mf / roof.flops) if roof.flops else None
        rec["memory_analysis"] = {
            "argument_bytes": lowered.argument_bytes,
            "output_bytes": lowered.output_bytes,
            "temp_bytes": None, "peak_bytes": None}     # not traced
        rec["heads_replicated"] = lowered.heads_replicated
    except Exception as e:       # a failure here is a bug in the system
        rec = {"cell": tag, "status": "FAILED",
               "error": f"{type(e).__name__}: {e}"[:1000],
               "traceback": traceback.format_exc()[-2000:]}
    if save:
        _save(tag, rec)
    if verbose:
        show = {k: v for k, v in rec.items() if k != "traceback"}
        print(json.dumps(show, default=str), flush=True)
    return rec


def _run(cell) -> dict:
    arch, shape, multi_pod, adapt, save = cell
    return run_cell(arch, shape, multi_pod=multi_pod,
                    windowed_adaptation=adapt, save=save)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--windowed-adaptation", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)

    lm_archs = [a for a in list_archs() if not a.startswith("ardit")]
    cells = []
    if args.all:
        for a in lm_archs:
            for s in SHAPES:
                cells.append((a, s, args.multi_pod, False))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells.append((args.arch, args.shape, args.multi_pod,
                      args.windowed_adaptation))

    cells = [c + (not args.no_save,) for c in cells]
    if args.jobs > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            recs = pool.map(_run, cells, chunksize=1)
    else:
        recs = [_run(c) for c in cells]
    return 1 if any(r["status"] == "FAILED" for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main())
