"""Workload generators (paper SS7.1 + App. B).

All five workloads share per-stream settings: 946 VBench prompts, target
lengths sampled from {81, 129, 161, 241} pixel frames (~5-15 s at 16 fps),
480p, 3 latent frames per chunk (12 pixel frames -> 0.75 s of playout).

    Steady         Poisson arrivals, lambda = 1 stream/s
    Burst          Steady + 3 burst points (20/50/80% progress), each
                   pulling 10% of all streams to arrive simultaneously
    Prompt-switch  Steady + per-stream condition switches (1-3 by length)
                   that reset playout slack to the initial TTFC
    Pause          Steady + client pauses (1-3 by length, each 20% of the
                   stream duration) during which slack accumulates
    Trace          enterprise-trace-shaped arrivals: interleaved steady
                   segments, bursts, and idle gaps
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Optional, Tuple

from repro_torch.sched_sim import cost_model as cm

N_PROMPTS = 946          # VBench prompt count


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    sid: int
    arrival: float
    frames: int                       # target pixel frames
    switches: Tuple[float, ...] = ()  # prompt-switch times (relative, s)
    pauses: Tuple[Tuple[float, float], ...] = ()   # (rel start, duration)
    model: Optional[str] = None       # co-serving: profile/model name

    @property
    def chunks(self) -> int:
        return math.ceil(self.frames / cm.PIXEL_FRAMES_PER_CHUNK)

    @property
    def duration(self) -> float:
        return self.frames / cm.FPS


def _poisson_arrivals(n: int, rate: float, rng: random.Random) -> List[float]:
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate)
        out.append(t)
    return out


def _lengths(n: int, rng: random.Random) -> List[int]:
    return [rng.choice(cm.STREAM_FRAMES) for _ in range(n)]


def steady(n: int = N_PROMPTS, rate: float = 1.0,
           seed: int = 0) -> List[StreamSpec]:
    rng = random.Random(seed)
    arr = _poisson_arrivals(n, rate, rng)
    return [StreamSpec(i, arr[i], f)
            for i, f in enumerate(_lengths(n, rng))]


def burst(n: int = N_PROMPTS, rate: float = 1.0,
          seed: int = 0) -> List[StreamSpec]:
    """10% of streams reassigned to each of 3 synchronized burst points."""
    rng = random.Random(seed)
    base = steady(n, rate, seed)
    arrivals = sorted(s.arrival for s in base)
    idx = list(range(n))
    rng.shuffle(idx)
    n_b = n // 10
    out = [dataclasses.replace(s) for s in base]
    cursor = 0
    for frac in (0.2, 0.5, 0.8):
        t_burst = arrivals[int(frac * (n - 1))]
        for j in idx[cursor:cursor + n_b]:
            out[j] = dataclasses.replace(out[j], arrival=t_burst)
        cursor += n_b
    return out


def _n_events(frames: int) -> int:
    return {81: 1, 129: 2, 161: 2, 241: 3}[frames]


def prompt_switch(n: int = N_PROMPTS, rate: float = 1.0,
                  seed: int = 0) -> List[StreamSpec]:
    rng = random.Random(seed)
    out = []
    for s in steady(n, rate, seed):
        ks = sorted(rng.uniform(0.1, 0.9) * s.duration
                    for _ in range(_n_events(s.frames)))
        out.append(dataclasses.replace(s, switches=tuple(ks)))
    return out


def pause(n: int = N_PROMPTS, rate: float = 1.0,
          seed: int = 0) -> List[StreamSpec]:
    rng = random.Random(seed)
    out = []
    for s in steady(n, rate, seed):
        dur = 0.2 * s.duration
        ps = tuple(sorted((rng.uniform(0.1, 0.9) * s.duration, dur)
                          for _ in range(_n_events(s.frames))))
        out.append(dataclasses.replace(s, pauses=ps))
    return out


def trace(n: int = N_PROMPTS, rate: float = 1.0,
          seed: int = 0) -> List[StreamSpec]:
    """Enterprise-trace-shaped arrivals: alternating steady segments
    (rates 0.6-1.6/s), flash bursts, and idle gaps (App. B).

    ``rate`` scales the whole trace's arrival intensity: segment rates
    are multiplied and idle gaps divided by it, so ``rate=2`` compresses
    the trace ~2x in time without changing its shape (at ``rate=1`` the
    rng consumption is unchanged, so pre-existing seeds reproduce)."""
    if rate <= 0.0:
        raise ValueError(f"trace rate must be positive, got {rate}")
    rng = random.Random(seed)
    arrivals: List[float] = []
    t = 0.0
    while len(arrivals) < n:
        kind = rng.random()
        if kind < 0.6:                       # steady segment
            seg_rate = rng.uniform(0.6, 1.6) * rate
            for _ in range(min(rng.randint(30, 120), n - len(arrivals))):
                t += rng.expovariate(seg_rate)
                arrivals.append(t)
        elif kind < 0.8:                     # flash burst
            k = min(rng.randint(5, 25), n - len(arrivals))
            arrivals.extend([t] * k)
        else:                                # idle gap
            t += rng.uniform(10.0, 40.0) / rate
    arrivals = arrivals[:n]
    rng2 = random.Random(seed + 1)
    return [StreamSpec(i, arrivals[i], rng2.choice(cm.STREAM_FRAMES))
            for i in range(n)]


def diurnal(n: int = N_PROMPTS, rate: float = 1.0, seed: int = 0,
            period: float = 1200.0,
            trough: float = 0.2) -> List[StreamSpec]:
    """Diurnal arrivals: a nonhomogeneous Poisson process whose rate
    follows one sinusoidal day-cycle, peak ``rate`` at mid-period and
    ``trough * rate`` at the edges (the fleet-scale sizing workload:
    autoscaling must track the swell, admission must absorb the crest).

    Sampled by thinning against the peak rate, so per-seed streams are
    deterministic and the instantaneous rate never exceeds ``rate``."""
    rng = random.Random(seed)
    arrivals: List[float] = []
    t = 0.0
    while len(arrivals) < n:
        t += rng.expovariate(rate)
        # lambda(t)/rate in [trough, 1]: sin half-wave over the period
        phase = (t % period) / period
        lam = trough + (1.0 - trough) * math.sin(math.pi * phase) ** 2
        if rng.random() < lam:
            arrivals.append(t)
    rng2 = random.Random(seed + 1)
    return [StreamSpec(i, arrivals[i], rng2.choice(cm.STREAM_FRAMES))
            for i in range(n)]


def flash_crowd(n: int = N_PROMPTS, rate: float = 1.0, seed: int = 0,
                spike_frac: float = 0.3,
                spike_width: float = 2.0) -> List[StreamSpec]:
    """Flash-crowd arrivals: a steady Poisson baseline carrying
    ``1 - spike_frac`` of the streams, with the remaining ``spike_frac``
    slammed into a ``spike_width``-second window at mid-trace (a viral
    event: the admission-control stress test — the spike exceeds any
    statically provisioned capacity, so the front door must queue,
    shed, or scale out)."""
    rng = random.Random(seed)
    n_spike = int(spike_frac * n)
    base = _poisson_arrivals(n - n_spike, rate, rng)
    t_spike = base[len(base) // 2] if base else 0.0
    spike = sorted(t_spike + rng.uniform(0.0, spike_width)
                   for _ in range(n_spike))
    arrivals = sorted(base + spike)
    rng2 = random.Random(seed + 1)
    return [StreamSpec(i, arrivals[i], rng2.choice(cm.STREAM_FRAMES))
            for i in range(n)]


def mixed_models(n: int = N_PROMPTS, rate: float = 1.0, seed: int = 0,
                 models: Tuple[str, ...] = ("causal-forcing",
                                            "self-forcing"),
                 weights: Optional[Tuple[float, ...]] = None
                 ) -> List[StreamSpec]:
    """Heterogeneous co-serving arrivals: ``steady`` with each stream
    tagged with a model drawn from ``models`` (uniform unless
    ``weights`` given).  A separate rng (``seed + 2``) does the model
    draws so arrivals and lengths match ``steady`` at the same seed —
    per-model sub-workloads are then directly comparable to the
    single-model run they were carved out of."""
    if not models:
        raise ValueError("mixed_models needs at least one model name")
    rng = random.Random(seed + 2)
    base = steady(n, rate, seed)
    picks = (rng.choices(list(models), weights=list(weights), k=n)
             if weights is not None else
             [rng.choice(list(models)) for _ in range(n)])
    return [dataclasses.replace(s, model=m) for s, m in zip(base, picks)]


WORKLOADS = {
    "steady": steady,
    "burst": burst,
    "prompt_switch": prompt_switch,
    "pause": pause,
    "trace": trace,
    "diurnal": diurnal,
    "flash_crowd": flash_crowd,
    "mixed_models": mixed_models,
}
