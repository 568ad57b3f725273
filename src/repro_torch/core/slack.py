"""Service credit (paper Eq. 1) and urgency tiers (SS4.1, SS7.5).

    C_u = P_u - (R_u + T_u)

P_u: playout slack (remaining playable buffer), R_u: estimated remaining
time of the running chunk (0 if not running), T_u: profiled generation
time of the next chunk under its selected fidelity configuration.

Tier thresholds (sensitivity-swept in Table 3, default alpha = 2):
    URGENT   C_u <  alpha * T_u
    RELAXED  C_u > 2*alpha * T_u
    NORMAL   otherwise
"""
from __future__ import annotations

from repro_torch.core.types import Stream, Tier

DEFAULT_ALPHA = 2.0


def service_credit(stream: Stream, now: float) -> float:
    p_u = stream.playout_slack(now)
    r_u = stream.remaining if stream.running_on else 0.0
    return p_u - (r_u + stream.t_next)


def classify(credit: float, t_next: float,
             alpha: float = DEFAULT_ALPHA) -> Tier:
    if credit < alpha * t_next:
        return Tier.URGENT
    if credit > 2.0 * alpha * t_next:
        return Tier.RELAXED
    return Tier.NORMAL


def update_stream_credit(stream: Stream, now: float,
                         alpha: float = DEFAULT_ALPHA) -> None:
    stream.credit = service_credit(stream, now)
    stream.tier = classify(stream.credit, stream.t_next, alpha)
