"""One multi-pod dry-run cell, end to end, on the port (the reference's
``examples/multi_pod_dryrun.py``): a fake process group of 512 ranks,
the 2 x 16 x 16 production mesh over it, the sharded train step traced
once on fake stand-ins (nothing allocated, no device touched), and the
roofline terms read off rank 0's count.

    PYTHONPATH=src python -m repro_torch.examples.multi_pod_dryrun \\
        [arch] [shape]

It takes no ``--device``: the trace runs on no device, as the port's
``launch/dryrun.py`` does.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.launch.dryrun import run_cell


def dryrun(arch: str = "granite-moe-1b-a400m",
           shape: str = "train_4k") -> dict:
    """The cell's record; raises unless it is ``ok`` or ``skipped``."""
    rec = run_cell(arch, shape, multi_pod=True, save=False)
    if rec["status"] not in ("ok", "skipped"):
        raise RuntimeError(f"dry-run cell {rec['cell']}: {rec}")
    return rec


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="granite-moe-1b-a400m")
    ap.add_argument("shape", nargs="?", default="train_4k")
    args = ap.parse_args(argv)
    return dryrun(args.arch, args.shape)


if __name__ == "__main__":
    main()
