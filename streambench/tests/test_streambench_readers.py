"""The readers of ``cpr.overload`` and ``ttfc_p95_s.overload`` on
hand-built stream records."""
import types

import pytest

from streambench.lib import bench
from streambench.lib.context import Ctx
from streambench.lib.playout import StreamRecord, Window, playout, summary

C = 0.75
K = "S4_r0.0_W7_bf16"


def ctx(streams, win):
    p = playout(streams, win, C)
    rec = types.SimpleNamespace(streams=streams, window=win)
    return Ctx("sf-saturate", {}, rec, p, summary(p, win), None)


def test_cpr_counts_a_late_chunk_as_due_and_not_on_time():
    # playout starts at 11.0; chunk 2 due 11.75, ready 12.5 (late); chunk
    # 3 due 13.25, ready 13.0 (on time); chunk 4 due 14.0, never ready
    s = StreamRecord(0, 10.0, 5, [11.0, 12.5, 13.0], [K] * 3)
    assert bench.reader("cpr.overload")(
        ctx([s], Window(11.5, 15.0, 15.2))) == pytest.approx(1 / 3)


def test_cpr_is_one_when_every_due_chunk_is_on_time():
    s = StreamRecord(0, 0.0, 7, [0.5, 0.9, 1.4, 2.0], [K] * 4)
    assert bench.reader("cpr.overload")(
        ctx([s], Window(0.0, 2.5, 2.6))) == 1.0


def test_cpr_reads_nothing_when_nothing_is_due():
    s = StreamRecord(0, 30.0, 7, [], [])
    assert bench.reader("cpr.overload")(
        ctx([s], Window(0.0, 10.0, 10.1))) is None


def test_ttfc_censors_an_unserved_stream_at_the_stop_and_leaves_out_earlier_arrivals():
    # a arrived before the window; b waits 0.5 s; c is never served and
    # enters at stop - arrival = 20.6 - 12.0
    a = StreamRecord(0, 5.0, 7, [9.0, 9.5], [K] * 2)
    b = StreamRecord(1, 11.0, 7, [11.5], [K])
    c = StreamRecord(2, 12.0, 7, [], [])
    got = bench.reader("ttfc_p95_s.overload")(
        ctx([a, b, c], Window(10.0, 20.0, 20.6)))
    assert got == pytest.approx(0.5 + 0.95 * (8.6 - 0.5))


def test_ttfc_reads_nothing_without_an_arrival_in_the_window():
    a = StreamRecord(0, 0.0, 7, [1.0, 2.0], [K] * 2)
    assert bench.reader("ttfc_p95_s.overload")(
        ctx([a], Window(10.0, 20.0, 20.1))) is None
