"""Serving launcher: real AR-DiT execution through the unified
``serve.session.StreamingSession`` on the card.

The sequential executor (the default, as in the reference launcher) or
the batched executor (``--batched``, with ``--context-backend paged``
or ``gather``) serves a workload from the ``sched_sim.workloads``
generators under the paper's control plane, and the run prints the same
one-line ``Summary.row()`` as the reference launcher's ``--real`` mode::

    PYTHONPATH=src python -m repro_torch.launch.serve --real \\
        --streams 2 --chunks 2                   # sequential executor
    PYTHONPATH=src python -m repro_torch.launch.serve --real --batched \\
        --workload burst --streams 6 --seed 0
    PYTHONPATH=src python -m repro_torch.launch.serve --real --batched \\
        --context-backend gather --streams 2     # gathered context
    PYTHONPATH=src python -m repro_torch.launch.serve --real --batched \\
        --streams 4 --pool-streams 2        # oversubscribed page pool
    PYTHONPATH=src python -m repro_torch.launch.serve --real \\
        --device cpu --streams 2 --chunks 2  # plain versions, on the host
    PYTHONPATH=src python -m repro_torch.launch.serve --real --lanes 2 \\
        --workload burst --streams 4 --chunks 2 --arrival-scale 0.2

``--lanes N`` serves through N batched executors (one KV pool each, all
on ``--device``) with re-homing and elastic SP on, as the reference's
``--lanes`` does; its ``--device-count`` forces XLA host devices and has
no torch counterpart (lanes on different devices wait for their slice).
The model is the reduced ``ardit-self-forcing`` config unless ``--arch``
names a registry config (``--arch ardit-self-forcing`` is full width).
The simulator (``--sim``), co-served models, the step cache and
calibration wait for their slices (ROADMAP: port queue).
"""
from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true", required=True,
                    help="real model execution (the simulator waits for "
                         "its slice)")
    ap.add_argument("--batched", action="store_true",
                    help="credit-ordered micro-batch executor (default: "
                         "the sequential executor)")
    ap.add_argument("--lanes", type=int, default=1,
                    help="lanes (> 1 implies the batched executor and "
                         "turns on re-homing and elastic SP)")
    ap.add_argument("--workers-per-node", type=int, default=0,
                    help="lanes per node for --lanes (0 -> all lanes in "
                         "one node)")
    ap.add_argument("--workload", default="steady")
    ap.add_argument("--streams", type=int, default=0,
                    help="stream count (default: 6, or 15 with --lanes "
                         "> 1 so each lane's queue exceeds a micro-batch)")
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--chunks", type=int, default=4,
                    help="per-stream chunk cap")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=0,
                    help="micro-batch cap (default: 4, or 3 with --lanes "
                         "> 1)")
    ap.add_argument("--budget-factor", type=float, default=0.0,
                    help="playout seconds per chunk as a multiple of "
                         "the measured top-fidelity latency (default: "
                         "4.0, or 2.0 with --lanes > 1: the tighter "
                         "budget keeps tail streams urgent so the "
                         "cross-lane mechanisms engage)")
    ap.add_argument("--arrival-scale", type=float, default=1.0,
                    help="multiply workload event times (< 1 compresses "
                         "Poisson gaps / trace idles)")
    ap.add_argument("--context-backend", default="paged",
                    choices=("paged", "gather"),
                    help="batched executor's context backend: attention "
                         "over the page pool in place, or over a context "
                         "gathered per chunk boundary")
    ap.add_argument("--pool-streams", type=int, default=0,
                    help="co-resident stream cap of the paged KV pool "
                         "(< --streams oversubscribes; 0 -> all fit)")
    ap.add_argument("--front-door", action="store_true",
                    help="SLO-aware admission control in front of the "
                         "scheduler, with admission stats in the report")
    ap.add_argument("--arch", default="",
                    help="registry config to serve at full width "
                         "(default: the reduced ardit-self-forcing)")
    ap.add_argument("--device", default="cuda",
                    help="device of the executor (default: the card)")
    args = ap.parse_args()
    multi = args.lanes > 1
    if multi:
        args.batched = True          # lanes ride the batched executor

    from repro_torch.configs.base import get_config
    from repro_torch.sched_sim.metrics import summarize, transfer_stats
    from repro_torch.sched_sim.workloads import WORKLOADS
    from repro_torch.serve.session import (SessionConfig, StreamingSession,
                                           cap_specs, scale_specs)

    n_streams = args.streams or (15 if multi else 6)
    raw = WORKLOADS[args.workload](n=n_streams, rate=args.rate,
                                   seed=args.seed)
    # multi-lane keeps the workload's length DIVERSITY (scaled into the
    # chunk budget): lanes then drain unevenly, which is what re-homing
    # and elastic SP exist to absorb
    specs = (scale_specs(raw, args.chunks) if multi
             else cap_specs(raw, args.chunks))
    fd_cfg = None
    if args.front_door:
        from repro_torch.sched_sim.frontdoor import FrontDoorConfig
        fd_cfg = FrontDoorConfig()        # autoscale forced off live
    session = StreamingSession(SessionConfig(
        executor="batched" if args.batched else "sequential",
        max_batch=args.max_batch or (3 if multi else 4),
        lanes=args.lanes,
        workers_per_node=args.workers_per_node,
        budget_factor=args.budget_factor or (2.0 if multi else 4.0),
        pool_streams=args.pool_streams or n_streams + 1,
        context_backend=args.context_backend,
        arrival_scale=args.arrival_scale,
        front_door=fd_cfg,
        model_cfg=get_config(args.arch) if args.arch else None,
        device=args.device,
        verbose=True))
    for spec in specs:
        session.submit(spec)
    res = session.run()
    s = summarize(res)
    label = (f"real-{args.lanes}-lane" if multi else
             "real-batched" if args.batched else "real-sequential")
    print(f"{label} on {args.workload}: {s.row()}")
    print(f"  rehomings={s.n_rehomings} elastic_sp={s.n_sp_events} "
          f"transfers={transfer_stats(res)}")
    if args.front_door:
        print(f"  admission: {res.admission}")
    if multi:
        print(f"  applied: migrations={res.n_migrations_applied} "
              f"sp_expands={res.n_sp_expands_applied} "
              f"sp_releases={res.n_sp_releases_applied}")


if __name__ == "__main__":
    main()
