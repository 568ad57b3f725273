"""The traffic generator: one mix gives one schedule, whatever the run's
seed; its order seed reorders the same work."""
import collections
import math

import pytest

from streambench.lib import traffic

MIX = {"rate": 0.2, "order_seed": 2**33 + 5, "ramp_s": 15.75,
       "frames": [81, 129, 161, 241]}


def test_same_mix_same_schedule():
    assert traffic.arrivals(MIX, 45) == traffic.arrivals(dict(MIX), 45)


def test_order_seeds_reorder_the_same_work():
    a = traffic.arrivals(dict(MIX, order_seed=1), 45)
    b = traffic.arrivals(dict(MIX, order_seed=2), 45)
    assert [x.arrival for x in a] != [x.arrival for x in b]
    assert collections.Counter(x.frames for x in a) == \
        collections.Counter(x.frames for x in b)
    gaps = lambda arr: sorted(round(y.arrival - x.arrival, 9)  # noqa: E731
                              for x, y in zip([traffic.Arrival(0, 0.0, 0)]
                                              + arr, arr))
    assert gaps(a) == gaps(b)


def test_arrivals_cover_ramp_and_window():
    a = traffic.arrivals(MIX, 45)
    assert [x.sid for x in a] == list(range(len(a)))
    assert all(x.arrival <= y.arrival for x, y in zip(a, a[1:]))
    assert a[-1].arrival > MIX["ramp_s"] + 45
    assert {x.chunks for x in a} == {7, 11, 14, 21}


def test_bursts_switches_pauses():
    mix = dict(MIX, bursts=[{"at": 0.5, "size": 3}],
               switches={"81": 1, "241": 3}, pauses={"129": 2})
    a = traffic.arrivals(mix, 45)
    t = 0.5 * (MIX["ramp_s"] + 45)
    assert sum(1 for x in a if x.arrival == t) >= 3
    for x in a:
        assert len(x.switches) == {81: 1, 241: 3}.get(x.frames, 0)
        assert len(x.pauses) == (2 if x.frames == 129 else 0)
        assert all(0.1 * x.duration <= s <= 0.9 * x.duration
                   for s in x.switches)


def test_gaps_are_the_exponential_quantiles():
    a = traffic.arrivals(MIX, 45)
    n = len(a)
    gaps = sorted(y.arrival - x.arrival
                  for x, y in zip([traffic.Arrival(0, 0.0, 0)] + a, a))
    want = [-math.log(1.0 - (i + 0.5) / n) / MIX["rate"] for i in range(n)]
    assert gaps == pytest.approx(want)
