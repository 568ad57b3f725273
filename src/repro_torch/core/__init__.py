"""SlackServe core: the paper's contribution.

    fidelity.py       the 90-config knob space (SS2.1, App. A)
    bmpr.py           Bi-Modal Pareto Routing (SS5)
    slack.py          service credit Eq. 1 + urgency tiers (SS4.1)
    queues.py         three-tier queues, credit-aware eviction (SS4.1)
    rehoming.py       bipartite re-homing planning (SS4.2, Alg. 1)
    elastic_sp.py     intra-node SP2 borrow/release (SS4.3)
    state_plane.py    paged KV pool + async transfer engine (SS4.4)
    control_plane.py  the 3 s control tick composing all of it (Alg. 2)

Pure control logic: the same code drives the discrete-event cluster
simulator (repro_torch.sched_sim) and the JAX chunk executor (repro_torch.serve).
"""
