"""Serving launcher.  Two modes, ONE workload spec and ONE metrics
surface, as the reference launcher's:

    --sim      cluster-scale discrete-event evaluation (the paper's SS7
               experiments): the real control plane over a modeled
               16-worker cluster, any workload and policy (no device).
    --real     real AR-DiT execution through the unified
               ``serve.session.StreamingSession`` on the card: the same
               ``ControlPlane.tick()`` decisions drive chunk generation.

In ``--real`` mode the sequential executor (the default, as in the
reference launcher) or the batched executor (``--batched``, with
``--context-backend paged`` or ``gather``) serves a workload from the
``sched_sim.workloads`` generators, and the run prints the same
one-line ``Summary.row()`` as the reference launcher::

    PYTHONPATH=src python -m repro_torch.launch.serve --sim \\
        --workload steady --policy slackserve --streams 50
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
    PYTHONPATH=src python -m repro_torch.launch.serve --real --lanes 2 \\
        --device-count 2 --workload burst --streams 4   # one card a lane
    PYTHONPATH=src python -m repro_torch.launch.serve --real --batched \\
        --step-cache              # the step cache as a fifth knob
    PYTHONPATH=src python -m repro_torch.launch.serve --real \\
        --models ardit-self-forcing,ardit-causal-forcing   # co-serving
    PYTHONPATH=src python -m repro_torch.launch.serve --real --batched \\
        --calibrate      # fit the simulator to the run, replay, compare

``--lanes N`` serves through N batched executors (one KV pool each, all
on ``--device``) with re-homing and elastic SP on, as the reference's
``--lanes`` does.  ``--device-count N`` round-robins the lanes over the
first N cards (``cuda:0`` ... ``cuda:N-1``) and stops with an error
when fewer are visible; it never puts a lane on the CPU (the
reference's flag forces N XLA host devices, which torch has no
counterpart of).  The model is the reduced ``ardit-self-forcing``
config unless ``--arch`` names a registry config (``--arch
ardit-self-forcing`` is full width); ``--models`` co-serves reduced
registry configs, each stream tagged round-robin.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def build_parser() -> argparse.ArgumentParser:
    """The launcher's options: every option of the reference's
    ``launch/serve.py``, plus ``--arch`` and ``--device``."""
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--sim", action="store_true",
                      help="discrete-event simulation of the cluster")
    mode.add_argument("--real", action="store_true",
                      help="real model execution")
    ap.add_argument("--policy", default="slackserve",
                    help="--sim scheduling policy (sched_sim.policies."
                         "make_policy: slackserve, sdv2, ts, ts-chunk or "
                         "an ablation)")
    ap.add_argument("--model", default="causal-forcing",
                    help="--sim model column of the latency profile")
    ap.add_argument("--models", default="",
                    help="comma-separated registry configs to CO-SERVE on "
                         "one lane pool (--real; implies --batched); "
                         "streams are tagged round-robin, the first model "
                         "is the primary bundle and the report adds "
                         "per-model Summary rows")
    ap.add_argument("--device-count", type=int, default=0,
                    help="round-robin the lanes over this many cards "
                         "(0: every lane on --device; more than are "
                         "visible is an error)")
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
    ap.add_argument("--streams", type=int, default=None,
                    help="stream count (default: 300 for --sim; for "
                         "--real 6, or 15 with --lanes > 1 so each lane's "
                         "queue exceeds a micro-batch)")
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
                         "scheduler (+ autoscaling under --sim), with "
                         "admission stats in the report")
    ap.add_argument("--step-cache", action="store_true",
                    help="unlock the step cache as a fifth fidelity axis: "
                         "BMPR routes over the 270-point frontier and "
                         "eligible denoise steps reuse cached residuals "
                         "(--real --batched)")
    ap.add_argument("--calibrate", action="store_true",
                    help="after a --real run, fit the simulator's cost "
                         "model to the session's measured EMAs, replay "
                         "the same specs through the calibrated simulator "
                         "and print the sim-vs-real QoE/TTFC agreement")
    ap.add_argument("--arch", default="",
                    help="registry config to serve at full width "
                         "(default: the reduced ardit-self-forcing)")
    ap.add_argument("--device", default="cuda",
                    help="device of the executor (default: the card)")
    return ap


def main() -> None:
    ap = build_parser()
    args = ap.parse_args()
    multi = args.lanes > 1
    if multi:
        args.batched = True          # lanes ride the batched executor
    if args.models:
        if not args.real:
            ap.error("--models only applies to --real (co-serving rides "
                     "the batched executor)")
        if args.arch:
            ap.error("--models and --arch are exclusive")
        args.batched = True          # co-serving rides the batched path
    devices = None
    if args.device_count:
        if not args.real:
            ap.error("--device-count only applies to --real")
        import torch
        visible = torch.cuda.device_count()
        if args.device_count > visible:
            ap.error(f"--device-count {args.device_count}: {visible} "
                     "card(s) visible")
        devices = [f"cuda:{i}" for i in range(args.device_count)]
        args.batched = True          # device lanes ride the batched path
    if args.pool_streams and not (args.real and args.batched):
        ap.error("--pool-streams only applies to --real --batched")
    if any(a.startswith("--context-backend") for a in sys.argv[1:]) \
            and not (args.real and args.batched):
        ap.error("--context-backend only applies to --real --batched")
    if multi and not args.real:
        ap.error("--lanes only applies to --real")
    if args.step_cache and not (args.real and args.batched):
        ap.error("--step-cache only applies to --real --batched (cache "
                 "hits ride the fused batched dispatch as no-op rows)")
    if args.calibrate and not args.real:
        ap.error("--calibrate only applies to --real (the sim IS the "
                 "model being calibrated)")

    if args.sim:
        _simulate(args)
        return

    from repro_torch.configs.base import get_config
    from repro_torch.sched_sim.metrics import summarize, transfer_stats
    from repro_torch.sched_sim.workloads import WORKLOADS
    from repro_torch.serve.session import (SessionConfig, StreamingSession,
                                           cap_specs, scale_specs)

    n_streams = (args.streams if args.streams is not None
                 else 15 if multi else 6)
    raw = WORKLOADS[args.workload](n=n_streams, rate=args.rate,
                                   seed=args.seed)
    # multi-lane keeps the workload's length DIVERSITY (scaled into the
    # chunk budget): lanes then drain unevenly, which is what re-homing
    # and elastic SP exist to absorb
    specs = (scale_specs(raw, args.chunks) if multi
             else cap_specs(raw, args.chunks))
    model_list = [m.strip() for m in args.models.split(",") if m.strip()]
    if model_list:
        specs = [dataclasses.replace(sp, model=model_list[i % len(model_list)])
                 for i, sp in enumerate(specs)]
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
        step_cache=args.step_cache,
        models=model_list or None,
        model_cfg=get_config(args.arch) if args.arch else None,
        device=args.device,
        devices=devices,
        verbose=True))
    for spec in specs:
        session.submit(spec)
    res = session.run()
    s = summarize(res)
    label = (f"real-{args.lanes}-lane" if multi else
             "real-batched" if args.batched else "real-sequential")
    if model_list:
        label += f"-coserve[{','.join(model_list)}]"
    print(f"{label} on {args.workload}: {s.row()}")
    for line in s.model_rows():
        print(line)
    print(f"  rehomings={s.n_rehomings} elastic_sp={s.n_sp_events} "
          f"transfers={transfer_stats(res)}")
    if args.front_door:
        print(f"  admission: {res.admission}")
    if args.step_cache:
        print(f"  step_cache: {res.step_cache} "
              f"avg_effective_window={s.avg_effective_window:.2f}")
    if args.calibrate:
        from repro_torch.sched_sim.calibration import agreement, fit_session
        from repro_torch.sched_sim.policies import make_policy
        from repro_torch.sched_sim.simulator import Simulator
        report = fit_session(session)
        sim_cfg = report.sim_config(
            n_workers=args.lanes,
            workers_per_node=args.workers_per_node or args.lanes)
        sim_res = Simulator(sim_cfg, specs, make_policy(
            "slackserve", model=report.model,
            profile=report.profile())).run()
        agr = agreement(s, summarize(sim_res))
        print(f"  calibration: scale={report.scale:.3f} "
              f"ratios={ {k: round(v, 3) for k, v in report.ratios.items()} }")
        print(f"  sim-vs-real: qoe {agr['qoe_sim']} vs "
              f"{agr['qoe_real']} (|d|={agr['qoe_delta']}, "
              f"tol {agr['qoe_tol']}), ttfc {agr['ttfc_sim_s']}s vs "
              f"{agr['ttfc_real_s']}s (rel={agr['ttfc_rel_err']}, "
              f"tol {agr['ttfc_rel_tol']}) -> "
              f"{'OK' if agr['ok'] else 'DISAGREE'}")
    if multi:
        print(f"  applied: migrations={res.n_migrations_applied} "
              f"sp_expands={res.n_sp_expands_applied} "
              f"sp_releases={res.n_sp_releases_applied}")
        # lanes placed by --device alone sit on the default device, as
        # the reference's lanes without --device-count do
        placement = ([str(d) for d in session.lanes.lane_devices] if devices
                     else ["default"] * args.lanes)
        print(f"  devices: {_visible(args.device)} visible, "
              f"lanes -> {placement}")
        ms = res.engine.measured_stats()
        if ms["count"]:
            print(f"  measured moves: n={ms['count']} "
                  f"bytes={ms['bytes']} "
                  f"bw={ms['bytes_per_s']:.3g} B/s "
                  f"(model {ms['bw_intra_model']:.3g} -> "
                  f"calibrated {ms['bw_intra_calibrated']:.3g})")


def _visible(device: str) -> int:
    """Devices of ``device``'s kind this process sees (the host is one)."""
    import torch
    return torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1


def _simulate(args) -> None:
    """The ``--sim`` branch: the reference launcher's, report lines and
    all."""
    from repro_torch.sched_sim.metrics import summarize, transfer_stats
    from repro_torch.sched_sim.policies import SDV2Policy, make_policy
    from repro_torch.sched_sim.simulator import SimConfig, Simulator
    from repro_torch.sched_sim.workloads import WORKLOADS

    specs = WORKLOADS[args.workload](
        n=args.streams if args.streams is not None else 300,
        rate=args.rate, seed=args.seed)
    policy = make_policy(args.policy, model=args.model)
    sim_cfg = (SDV2Policy.sim_config() if args.policy == "sdv2"
               else SimConfig(model=args.model))
    if args.front_door:
        from repro_torch.sched_sim.frontdoor import FrontDoorConfig
        sim_cfg = dataclasses.replace(sim_cfg, front_door=FrontDoorConfig())
    res = Simulator(sim_cfg, specs, policy).run()
    s = summarize(res)
    print(f"{args.policy} on {args.workload}: {s.row()}")
    for line in s.model_rows():          # mixed_models workload
        print(line)
    print(f"  rehomings={s.n_rehomings} elastic_sp={s.n_sp_events} "
          f"transfers={transfer_stats(res)}")
    if args.front_door:
        print(f"  admission: {res.admission} "
              f"(final workers: {res.n_workers_final})")


if __name__ == "__main__":
    main()
