"""The one traffic generator: App. B's stream mixes from a data file.

A traffic file (``streambench/traffic/<name>.json``) holds the parameters:

    rate            arrivals a second of the open loop (streams/s), a
                    Poisson process: its gaps are the exponential
                    distribution's quantiles at that rate
    order_seed      the seed that orders the gaps and the lengths and draws
                    switch and pause points
    ramp_s          seconds of arrivals before the measured window opens
    frames          target lengths in pixel frames, drawn in equal shares
    bursts          [{"at": share of ramp + window, "size": streams}]:
                    extra streams that arrive together (App. B Burst)
    switches        {"<frames>": n}: prompt switches a stream of that
                    length makes, at uniform points of its playout
    pauses          {"<frames>": n} and ``pause_share``: client pauses of
                    that share of the stream's playout

Every run of a mix offers the same arrivals in the same order: the run's
seed makes the weights, the conditioning and the noise, never the work.
Enough arrivals are made to cover the ramp and the window; those after the
end never arrive.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Tuple

FPS = 16
PIXEL_FRAMES_PER_CHUNK = 12        # 3 latent frames x 4 (VAE temporal rate)
CHUNK_SECONDS = PIXEL_FRAMES_PER_CHUNK / FPS          # 0.75 s of playout


@dataclasses.dataclass(frozen=True)
class Arrival:
    sid: int
    arrival: float
    frames: int
    switches: Tuple[float, ...] = ()
    pauses: Tuple[Tuple[float, float], ...] = ()

    @property
    def chunks(self) -> int:
        return math.ceil(self.frames / PIXEL_FRAMES_PER_CHUNK)

    @property
    def duration(self) -> float:
        return self.frames / FPS


def arrivals(traffic: Dict, seconds: float) -> List[Arrival]:
    """The streams a run offers, in arrival order, sids from 0."""
    rng = random.Random(int(traffic["order_seed"]))
    rate = float(traffic["rate"])
    span = float(traffic["ramp_s"]) + float(seconds)
    n = int(math.ceil(rate * span * 1.1)) + 1
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    rng.shuffle(gaps)
    frames = [traffic["frames"][i % len(traffic["frames"])]
              for i in range(n)]
    rng.shuffle(frames)
    times, t = [], 0.0
    for g in gaps:
        t += g
        times.append(t)
    for b in traffic.get("bursts", []):
        k = int(b["size"])
        times.extend([float(b["at"]) * span] * k)
        frames.extend(frames[i % n] for i in range(k))
    order = sorted(range(len(times)), key=lambda i: (times[i], i))
    out = []
    switches = {int(k): int(v) for k, v in traffic.get("switches", {}).items()}
    pauses = {int(k): int(v) for k, v in traffic.get("pauses", {}).items()}
    share = float(traffic.get("pause_share", 0.2))
    for sid, i in enumerate(order):
        f = frames[i]
        dur = f / FPS
        sw = tuple(sorted(rng.uniform(0.1, 0.9) * dur
                          for _ in range(switches.get(f, 0))))
        ps = tuple(sorted((rng.uniform(0.1, 0.9) * dur, share * dur)
                          for _ in range(pauses.get(f, 0))))
        out.append(Arrival(sid, times[i], f, sw, ps))
    return out
