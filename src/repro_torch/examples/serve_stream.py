"""End-to-end real serving on the port: BMPR-driven fidelity on actual
AR-DiT chunk generation with playout-slack bookkeeping, driven by the
unified ``repro_torch.serve.session.StreamingSession`` control loop (the
reference's ``examples/serve_stream.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_stream [n] [chunks]
    ... serve_stream --batched [--pool P] [--context-backend gather] [n] [c]
    ... serve_stream --batched --workload burst --arrival-scale 0.25 4 2
    ... serve_stream --lanes 2 --workload burst 9 4
    (add --device cpu to run on the CPU)

``--batched`` serves every stream through the credit-ordered micro-batch
executor instead of one stream at a time.  ``--pool P`` caps the page
pool at P co-resident streams (P < n oversubscribes: overflow streams
spill to the host and rotate back in).  ``--context-backend`` picks how
sub-batches see cached KV: ``paged`` (default) reads the page pool in
place through block tables, ``gather`` materializes the context per
chunk boundary.  ``--workload steady|burst|...`` replaces the default
everyone-at-t=0 arrivals with online arrivals from the named
``sched_sim.workloads`` generator; ``--arrival-scale`` compresses its
event times.  ``--lanes N`` serves through N lanes (one batched executor
and paged KV pool each) under the full control plane: re-homing moves KV
between lanes and elastic SP splits heads over a donor lane (the
applied counts are printed at the end).  The run ends with the
simulator's CPR/TTFC ``Summary`` line.  The model is the reduced
``ardit-self-forcing``, on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.examples._device import resolve
from repro_torch.sched_sim.metrics import summarize
from repro_torch.sched_sim.workloads import WORKLOADS
from repro_torch.serve.session import (SessionConfig, StreamingSession,
                                       cap_specs, uniform_specs)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_streams", nargs="?", type=int, default=2)
    ap.add_argument("chunks", nargs="?", type=int, default=4)
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--lanes", type=int, default=1,
                    help="lanes (> 1 implies --batched)")
    ap.add_argument("--pool", type=int, default=None,
                    help="co-resident streams of the page pool (batched)")
    ap.add_argument("--context-backend", default=None,
                    choices=("gather", "paged"))
    ap.add_argument("--workload", default=None, choices=sorted(WORKLOADS))
    ap.add_argument("--arrival-scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="device of the executors (default: the card)")
    return ap


def serve(n_streams: int = 2, chunks: int = 4, *, batched: bool = False,
          lanes: int = 1, pool: Optional[int] = None,
          context_backend: str = "paged", workload: Optional[str] = None,
          arrival_scale: float = 1.0, device="cuda"):
    """One session: ``n_streams`` streams of ``chunks`` chunks each (or
    the workload's streams capped at ``chunks``).  Returns the stream
    handles and the session's result."""
    if workload is None:
        specs = uniform_specs(n_streams, chunks)       # all at t = 0
    else:
        specs = cap_specs(WORKLOADS[workload](n=n_streams, seed=0), chunks)
    session = StreamingSession(SessionConfig(
        executor="batched" if batched or lanes > 1 else "sequential",
        lanes=lanes, pool_streams=pool or (n_streams + 1),
        context_backend=context_backend, arrival_scale=arrival_scale,
        device=device))
    handles = [session.submit(spec) for spec in specs]
    return handles, session.run()


def main(argv: Optional[List[str]] = None):
    ap = build_parser()
    args = ap.parse_args(argv)
    batched = args.batched or args.lanes > 1          # lanes ride batched
    if args.pool is not None and not batched:
        ap.error("--pool only applies to the batched executor; add "
                 "--batched")
    if args.context_backend is not None and not batched:
        ap.error("--context-backend only applies to the batched executor; "
                 "add --batched")
    device = resolve(args.device)
    handles, res = serve(
        args.n_streams, args.chunks, batched=batched, lanes=args.lanes,
        pool=args.pool, context_backend=args.context_backend or "paged",
        workload=args.workload, arrival_scale=args.arrival_scale,
        device=device)

    print("\nper-stream fidelity decisions:")
    for h in handles:
        print(f"  stream {h.sid}: {h.fidelity_log}")
    label = (f"{args.lanes}-lane" if args.lanes > 1 else
             "batched" if batched else "sequential")
    print(f"{label} on {args.workload or 'all-at-t0'}: "
          f"{summarize(res).row()}")
    if args.lanes > 1:
        print(f"applied: migrations={res.n_migrations_applied} "
              f"sp_expands={res.n_sp_expands_applied} "
              f"sp_releases={res.n_sp_releases_applied}")
    return handles, res


if __name__ == "__main__":
    main()
