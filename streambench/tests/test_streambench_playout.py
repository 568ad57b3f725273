"""The playout rule and censoring on hand-made timelines."""
import pytest

from streambench.lib.playout import (StreamRecord, Window, deadlines,
                                     percentile, playout, summary)

C = 0.75


def test_deadlines_resume_after_a_late_chunk():
    # playout starts at the first ready chunk
    ddl, nxt = deadlines([1.0, 1.5, 3.0, 3.1], chunk_s=C)
    assert ddl == [1.0, 1.75, 2.5, 3.75]
    assert nxt == pytest.approx(4.5)


def test_no_deadline_before_the_first_chunk():
    assert deadlines([], chunk_s=C) == ([], None)


def test_window_counts_due_chunks_and_missing_ones():
    # arrival 10, first ready 11 (playout starts); ready 12.5 (due 11.75,
    # late), 13.0 (due 13.25, on time), then the fourth due 14.0, never
    # ready by the stop
    s = StreamRecord(0, 10.0, 5, [11.0, 12.5, 13.0], ["S4_r0.0_W7_bf16"] * 3)
    p = playout([s], Window(11.5, 15.0, 15.2), C)
    assert (p.due, p.on_time, p.failed) == (3, 1, 0)
    assert p.cpr == pytest.approx(1 / 3)
    assert p.ready_in_window == 2
    assert p.arrivals == 0


def test_ttfc_censored_at_the_stop():
    served = StreamRecord(1, 20.0, 7, [21.5], ["k"])
    waiting = StreamRecord(2, 24.0, 7, [], [])
    before = StreamRecord(3, 5.0, 7, [6.0], ["k"])
    p = playout([served, waiting, before], Window(15.0, 25.0, 25.3), C)
    assert sorted(p.ttfc) == pytest.approx([1.3, 1.5])
    assert p.censored == 1
    out = summary(p, Window(15.0, 25.0, 25.3))
    assert out["ttfc_p95_s"] == pytest.approx(1.3 + 0.95 * 0.2)
    assert out["chunks_per_s"] == pytest.approx(0.1)


def test_refused_stream_counts_as_failed_and_in_the_tail():
    # refused at 20: chunks due 20, 20.75, ..., 24.5 (7 of them) in the
    # window [15, 25): all due, all lost
    refused = StreamRecord(4, 20.0, 7, [], [], refused=True)
    p = playout([refused], Window(15.0, 25.0, 25.5), C)
    assert (p.due, p.on_time, p.failed) == (7, 0, 7)
    assert p.ttfc == [5.5] and p.censored == 1


def test_percentile_matches_linear_interpolation():
    assert percentile([3.0, 1.0, 2.0, 4.0], 0.5) == 2.5
    assert percentile([5.0], 0.95) == 5.0
