"""Device time of the measured window from ``torch.profiler``, reduced to a
summary in memory (no trace file is written).

The profiler records the card's activity only.  Its clock is tied to the
host's by one marker kernel launched right after the profiler starts on an
idle device, so that each idle gap can be labelled with the harness span
that was open on the host at the time.
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Sequence, Tuple

import torch

GEMM = ("gemm", "cutlass", "xmma", "cublas", "nvjet")
MARKER_CYCLES = 20000


def category(name: str) -> str:
    """Coarse class of a kernel by name, as the port's step profiler
    classes them: the paged kernel, fp32 matmuls (the attention segments'
    einsums), other matmuls (the linear layers), exp and reductions, the
    rest."""
    low = name.lower()
    if "paged_chunk_attention" in low:
        return "paged_chunk_attention (kernel 1)"
    if "flash_mha" in low:
        return "flash_mha (kernel 3)"
    if any(k in low for k in GEMM):
        if "f32f32" in low:
            return "matmul fp32 (attention einsums)"
        return "matmul (linear layers)"
    if any(k in low for k in ("exp", "reduce", "max", "sum", "softmax")):
        return "exp / reductions"
    return "other elementwise / copies"


class DeviceTrace:
    """Start and stop the profiler around the window; ``reduce`` it."""

    def __init__(self):
        self.prof = None
        self.t_start = self.t_end = self.t_mark = 0.0

    def prime(self) -> None:
        """Profile one small operation, so that the profiler's own start-up
        (CUPTI's) falls in set-up and not in the window."""
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t_end = time.perf_counter()
        self.prof.stop()

    def reduce(self, spans: Sequence[Tuple[float, float, str]]) -> Dict:
        """Busy seconds, window seconds, device time by category, kernel
        1's time, and the longest idle gaps labelled by the host span open
        at their middle.  ``spans`` are (start, end, label)
        on the host's ``perf_counter`` clock."""
        evs = [e for e in self.prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        evs.sort(key=lambda e: e.time_range.start)
        marker = next((e for e in evs if "sleep" in e.name.lower()
                       or "spin" in e.name.lower()), evs[0] if evs else None)
        # host seconds = trace microseconds * 1e-6 + offset
        offset = (self.t_mark - marker.time_range.start * 1e-6
                  if marker is not None else 0.0)
        lo, hi = self.t_start, self.t_end
        by_cat: collections.Counter = collections.Counter()
        intervals: List[Tuple[float, float]] = []
        for e in evs:
            if e is marker:
                continue
            s = e.time_range.start * 1e-6 + offset
            t = e.time_range.end * 1e-6 + offset
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            by_cat[category(e.name)] += t - s
            intervals.append((s, t))
        busy, gaps = 0.0, []
        cur_s, cur_t = lo, lo
        for s, t in intervals:
            if s > cur_t:
                busy += cur_t - cur_s
                gaps.append((cur_t, s))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
        busy += cur_t - cur_s
        if hi > cur_t:
            gaps.append((cur_t, hi))
        label = _labeller(spans)
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {
            "busy_s": busy, "window_s": hi - lo, "t_start": lo, "t_end": hi,
            "by_category": dict(by_cat),
            "paged_s": by_cat["paged_chunk_attention (kernel 1)"],
            "longest_gaps": [(label(0.5 * (a + b)), b - a)
                             for a, b in longest],
            "n_kernels": len(intervals)}


def _labeller(spans: Sequence[Tuple[float, float, str]]):
    """time -> label of the span open at that time (the latest to start),
    or the loop between spans."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]

    def label(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][1] >= t:
            return spans[i][2]
        return "session loop outside tick and step"
    return label
