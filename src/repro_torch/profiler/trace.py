"""In-process tracer of the serving path: spans, counters and per-chunk
records, kept in memory between ``start()`` and ``stop()``.

Off by default.  While off, the module's record is ``None``: a call site
costs one global read and an ``is None`` test, and ``span`` /
``device_span`` return one shared no-op context whose ``__enter__``
gives None.  Nothing is written to a file; ``stop()`` returns the
``Record``.

One clock.  Host spans read ``time.perf_counter()``.  A device span is a
pair of CUDA timing events recorded on the device's current stream;
``stop()`` synchronizes once and places each event on the host clock.
Anchors tie the card's clock to the host's: an event recorded on the
idle card between two ``perf_counter`` reads, before its record and
after its completion, by ``start()``, by ``synced`` (which the executor
calls after each wait for the card) and by ``stop()``.  The card's timer
and the host's clock need not run at one rate, so an event is placed by
linear interpolation between the anchors around it; an anchor whose
bracket is wider than ``ANCHOR_WIDTH_S`` (the host was held up around
the record) places nothing.  ``Record.clock`` keeps every anchor.  A device
span over CPU tensors, or on a card ``start()`` did not anchor, is timed
on the host.

What the serving path records:

=======================  ===============================================
span                     where, and its attributes
=======================  ===============================================
session.schedule         between rounds: arrivals and stream events,
                         remaining times, the tick or the credit order
session.round            one step round over the lanes: ``runnable``
                         and ``admitted`` streams per lane, ``launches``
session.tick             the control tick (the two clock reads behind
                         ``ControlPlane.tick_times``)
session.residency        making one lane's micro-batch page-resident:
                         ``evictions``, ``restores``, ``deferrals``,
                         ``refused``
session.begin_chunk      a chunk's fidelity choice: ``sid``, ``tier``,
                         ``budget`` (s), ``fidelity``, ``predicted`` (s)
session.complete_chunk   a chunk's playout bookkeeping: ``sid``,
                         ``lateness`` (s past its deadline; <= 0 on time)
session.idle             the loop's naps while nothing can run
executor.run_step        one sub-batch step: ``sids``, ``rows``,
                         ``keys``, ``chunk_idx``, ``denoise``,
                         ``launched``
executor.boundary        block tables and masks (cached a chunk boundary)
executor.staging         the rows' latents joined, the step's scalars
model.launch             the host's enqueue of the model step
executor.append          the completed rows' KV written into the pool
executor.sync            the one wait for the device a completion makes
executor.complete        logs and latency EMAs after that wait
device.step              (device) one launch of the model step
device.attn.context      (device) kernel 1 over a layer's paged context
device.attn.chunk        (device) a layer's in-chunk segment, its merge
                         with the context's partials and the output's
                         layout
=======================  ===============================================

Counters, from ``session.round``: ``rounds``; ``launches`` and the
``rows`` they carried; ``split_launches``, launches beyond the first of
a lane's micro-batch in a round (one per further KV-dtype group);
``runnable``, streams runnable on a lane, capped at the micro-batch;
``residency_refused``, runnable streams that could not be made resident.
And the rise between ``start()`` and ``stop()`` of the kernel wrappers'
own counts that ``WRAPPER_COUNTS`` names, where it is above 0:
``flash_mha.launches_seeded``, ``paged_mha``'s in-chunk segments on
kernel 3's seeded form, and ``flash_mha.plain_segments``, those on its
plain version.

Chunk records (``Record.chunks``, one a completed chunk): ``sid``,
``tier`` and ``budget`` and ``fidelity`` at the chunk's start,
``runnable`` (when the stream's previous chunk was ready, or the stream
arrived), ``begin``, ``ready`` (host clock), and ``active_s``, the
seconds of the steps the chunk took part in.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import math
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# the record being written, or None while tracing is off
_REC: Optional["Record"] = None
# an anchor whose record-to-completion bracket on the host is wider than
# this places no device time
ANCHOR_WIDTH_S = 50e-6
# counts kept on kernel wrappers (module, function, attribute) that a
# record also holds, as their rise while it records, under
# "<function>.<attribute>"
WRAPPER_COUNTS = (
    ("repro_torch.kernels.flash_attention.ops", "flash_mha",
     "launches_seeded"),
    ("repro_torch.kernels.flash_attention.ops", "flash_mha",
     "plain_segments"),
)


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float = math.nan
    # index in ``Record.spans`` of the innermost host span open when this
    # one began; -1 for none
    parent: int = -1
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Record:
    t_start: float
    t_end: float = math.nan
    spans: List[Span] = dataclasses.field(default_factory=list)
    device_spans: List[Span] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)
    chunks: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # each chunk in flight: its fidelity choice, for its record
    begun: Dict[int, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    _open: List[int] = dataclasses.field(default_factory=list)
    _events: List[Tuple[Span, Any, Any, int]] = dataclasses.field(
        default_factory=list)
    # device index -> anchors: (device seconds since the first, host
    # time, width of its host bracket), filled in by stop()
    clock: Dict[int, List[Tuple[float, float, float]]] = \
        dataclasses.field(default_factory=dict)
    # device index -> [(anchor event, host reads before its record and
    # after its completion)]
    _anchors: Dict[int, List[Tuple[Any, float, float]]] = \
        dataclasses.field(default_factory=dict)
    # WRAPPER_COUNTS' values at start()
    _wrapper_counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def _parent(self) -> int:
        return self._open[-1] if self._open else -1

    def _push(self, name: str, attrs: Dict[str, Any]) -> Span:
        sp = Span(name, time.perf_counter(), parent=self._parent(),
                  attrs=attrs)
        self._open.append(len(self.spans))
        self.spans.append(sp)
        return sp

    def _pop(self, sp: Span) -> None:
        sp.end = time.perf_counter()
        for k in range(len(self._open) - 1, -1, -1):
            if self.spans[self._open[k]] is sp:
                del self._open[k]
                break

    def add_span(self, name: str, start: float, end: float,
                 **attrs: Any) -> Span:
        """A host span timed by the caller (no child can open in it)."""
        sp = Span(name, start, end, parent=self._parent(), attrs=attrs)
        self.spans.append(sp)
        return sp


def labeller(spans: Sequence[Span]) -> Callable[[float], Optional[Span]]:
    """``t ->`` the innermost of ``spans`` open at ``t``, or None.

    Host spans nest, so every span open at ``t`` encloses the latest one
    to start at or before ``t``: walk its parents to the first still
    open."""
    order = sorted(range(len(spans)), key=lambda i: spans[i].start)
    starts = [spans[i].start for i in order]

    def at(t: float) -> Optional[Span]:
        k = bisect.bisect_right(starts, t) - 1
        i = order[k] if k >= 0 else -1
        while i >= 0 and not spans[i].end >= t:
            i = spans[i].parent
        return spans[i] if i >= 0 else None
    return at


class _Null:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


class _HostSpan:
    __slots__ = ("rec", "name", "attrs", "span")

    def __init__(self, rec: Record, name: str, attrs: Dict[str, Any]):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self) -> Span:
        self.span = self.rec._push(self.name, self.attrs)
        return self.span

    def __exit__(self, *exc) -> bool:
        self.rec._pop(self.span)
        return False


class _HostTimedDeviceSpan:
    """A device span over host work (CPU tensors): timed on the host,
    kept with the device spans, never a parent."""
    __slots__ = ("rec", "span")

    def __init__(self, rec: Record, name: str, attrs: Dict[str, Any]):
        self.rec = rec
        self.span = Span(name, math.nan, parent=rec._parent(), attrs=attrs)

    def __enter__(self) -> Span:
        self.span.start = time.perf_counter()
        return self.span

    def __exit__(self, *exc) -> bool:
        self.span.end = time.perf_counter()
        self.rec.device_spans.append(self.span)
        return False


class _DeviceSpan:
    __slots__ = ("rec", "span", "index", "stream", "ev0")

    def __init__(self, rec: Record, name: str, index: int,
                 attrs: Dict[str, Any]):
        self.rec, self.index = rec, index
        self.span = Span(name, math.nan, parent=rec._parent(), attrs=attrs)

    def __enter__(self) -> Span:
        torch = sys.modules["torch"]
        self.stream = torch.cuda.current_stream(self.index)
        self.ev0 = torch.cuda.Event(enable_timing=True)
        self.ev0.record(self.stream)
        return self.span

    def __exit__(self, *exc) -> bool:
        ev1 = sys.modules["torch"].cuda.Event(enable_timing=True)
        ev1.record(self.stream)
        self.rec.device_spans.append(self.span)
        self.rec._events.append((self.span, self.ev0, ev1, self.index))
        return False


def active() -> Optional[Record]:
    """The record being written, or None while tracing is off."""
    return _REC


def span(name: str, **attrs: Any):
    """Context for a host span; ``with ... as sp`` gives the ``Span`` (its
    ``attrs`` may be filled in) or None while tracing is off."""
    rec = _REC
    if rec is None:
        return _NULL
    return _HostSpan(rec, name, attrs)


def device_span(name: str, device, **attrs: Any):
    """Context for a device span over the work enqueued on ``device``
    (a ``torch.device``) inside it."""
    rec = _REC
    if rec is None:
        return _NULL
    if device.type == "cuda":
        index = _index(device)
        if index in rec._anchors:
            return _DeviceSpan(rec, name, index, attrs)
    return _HostTimedDeviceSpan(rec, name, attrs)


def _index(device) -> int:
    if device.index is not None:
        return device.index
    return sys.modules["torch"].cuda.current_device()


def _anchor(rec: Record, index: int) -> None:
    """An event on the idle card, bracketed by host reads before its
    record and after its completion."""
    torch = sys.modules["torch"]
    stream = torch.cuda.current_stream(index)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)                   # builds the event
    t0 = time.perf_counter()
    ev.record(stream)
    ev.synchronize()
    rec._anchors.setdefault(index, []).append((ev, t0, time.perf_counter()))


def synced(device) -> None:
    """Call right after a synchronize of ``device`` (a ``torch.device``):
    while the card is idle, an anchor of its clock to the host's."""
    rec = _REC
    if rec is None or device.type != "cuda":
        return
    index = _index(device)
    if index in rec._anchors:
        _anchor(rec, index)


def _placer(anchors: List[Tuple[float, float]]) -> Callable[[float], float]:
    """Device seconds since the first anchor -> host time, linear between
    the anchors around it (the last stretch's rate past the last)."""
    g = [a for a, _ in anchors]

    def place(x: float) -> float:
        k = min(max(bisect.bisect_right(g, x) - 1, 0), len(g) - 2)
        if k < 0:                       # one anchor
            return anchors[0][1] + x
        (g0, t0), (g1, t1) = anchors[k], anchors[k + 1]
        rate = (t1 - t0) / (g1 - g0) if g1 > g0 else 1.0
        return t0 + (x - g0) * rate
    return place


def _read_wrapper_counts() -> Dict[str, int]:
    """WRAPPER_COUNTS' values now (0 for a module not yet imported, whose
    counts start at 0)."""
    counts = {}
    for module, fn, attr in WRAPPER_COUNTS:
        mod = sys.modules.get(module)
        counts[f"{fn}.{attr}"] = \
            getattr(getattr(mod, fn), attr) if mod is not None else 0
    return counts


def start() -> Record:
    """Turn tracing on.  Device spans are timed on the current card,
    anchored here after a synchronize; before CUDA is initialized, no
    card is anchored."""
    global _REC
    if _REC is not None:
        raise RuntimeError("tracing is already on")
    rec = Record(t_start=math.nan)
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        i = torch.cuda.current_device()
        torch.cuda.synchronize(i)
        _anchor(rec, i)
    rec._wrapper_counts = _read_wrapper_counts()
    rec.t_start = time.perf_counter()
    _REC = rec
    return rec


def stop() -> Optional[Record]:
    """Turn tracing off and return the record (None if it was off), its
    device spans placed on the host clock."""
    global _REC
    rec, _REC = _REC, None
    if rec is None:
        return None
    rec.t_end = time.perf_counter()
    for name, n in _read_wrapper_counts().items():
        if n > rec._wrapper_counts[name]:
            rec.counters[name] += n - rec._wrapper_counts[name]
    if rec._anchors:
        torch = sys.modules["torch"]
        for i in rec._anchors:
            torch.cuda.synchronize(i)
            _anchor(rec, i)
        place = {}
        for i, anchors in rec._anchors.items():
            first = anchors[0][0]
            rec.clock[i] = clock = [
                (first.elapsed_time(ev) * 1e-3, 0.5 * (t0 + t1), t1 - t0)
                for ev, t0, t1 in anchors]
            tight = [(g, t) for g, t, w in clock if w <= ANCHOR_WIDTH_S] \
                or [min(clock, key=lambda a: a[2])[:2]]
            place[i] = (first, _placer(tight))
        for sp, ev0, ev1, i in rec._events:
            first, at = place[i]
            sp.start = at(first.elapsed_time(ev0) * 1e-3)
            sp.end = at(first.elapsed_time(ev1) * 1e-3)
        rec._events.clear()
        rec._anchors.clear()
    return rec
