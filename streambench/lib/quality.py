"""The frozen quality yardstick: the paper's App. A VBench response surface
over the fidelity knobs, keyed by model.

It is an analytic surface, not a measurement, and the fixed scale on which
the benchmark prices the fidelity mix a run delivered.  Constants are frozen
here: the program's own copy may change without moving this yardstick.
"""
from __future__ import annotations

Q_MAX = {"causal-forcing": 81.3, "self-forcing": 80.9}
A_S, A_RHO, A_W, A_Q, A_INT = 0.55, 2.6, 1.1, 0.35, 0.8
A_CACHE = {"off": 0.0, "c": 0.18, "a": 0.5}
W_MAX = 7


def chunk_quality(key: str, model: str) -> float:
    """VBench points of one chunk made at fidelity ``key``
    (``S<steps>_r<rho>_W<window>_<quant>[_c<level>]``)."""
    parts = key.split("_")
    steps, rho = int(parts[0][1:]), float(parts[1][1:])
    window, quant = int(parts[2][1:]), parts[3]
    cache = parts[4][1] if len(parts) > 4 else "off"
    vis = min(window, W_MAX) / W_MAX
    q = Q_MAX[model]
    q -= A_S * (4 - steps) ** 1.6
    q -= A_RHO * (rho ** 2.5) * (vis ** 0.5)
    q -= A_W * (1.0 - vis) ** 1.4
    q -= A_Q * (1.0 if quant == "fp8" else 0.0)
    q -= A_INT * rho * (4 - steps) / 2.0
    q -= A_CACHE[cache]
    return q
