"""Discrete-event cluster simulator reproducing the paper's evaluation.

The simulator drives the REAL control-plane code (repro_torch.core) on
a virtual clock over a modeled 16-worker / 2-node cluster (the paper's
16xH100 testbed), or any other topology.  Workloads follow App. B;
baselines (SDV2 / TS / TS-chunk) follow SS7.1; metrics follow SS7.1
(QoE = CPR, TTFC, quality, stalls).  ``calibration`` fits its cost
model to a real session's measurements.
"""
from repro_torch.sched_sim.simulator import Simulator, SimConfig  # noqa: F401
