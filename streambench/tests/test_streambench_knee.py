"""The sweep's rules: the knee and the plateau from hand-written sweep
lines, the backlog at the window's close from hand-built stream records,
and the ``knee`` mode over files of them."""
import json
import sys

import pytest

from streambench import calibrate
from streambench.lib.playout import StreamRecord


def point(rate, seed, cpr, cps, backlog=0, failed=0):
    return {"rate": rate, "order_seed": seed, "cpr": cpr,
            "chunks_per_s": cps, "backlog": backlog, "failed": failed}


SWEEP = [
    point(0.08, 1, 1.0, 1.0), point(0.08, 2, 1.0, 1.02),
    point(0.1, 1, 0.95, 1.3), point(0.1, 2, 0.92, 1.28),
    point(0.12, 1, 0.91, 1.5), point(0.12, 2, 0.89, 1.52),  # order 2 misses
    point(0.2, 1, 0.6, 2.6, backlog=3), point(0.2, 2, 0.62, 2.5, backlog=2),
    point(0.4, 1, 0.4, 3.0, backlog=8), point(0.4, 2, 0.41, 3.04, backlog=9),
    point(0.8, 1, 0.3, 3.1, backlog=9), point(0.8, 2, 0.31, 3.08, backlog=9),
]


def test_one_seed_below_the_cpr_floor_keeps_a_rate_off_the_knee():
    got = calibrate.knee_plateau(SWEEP)
    assert got["knee"] == 0.1


def test_plateau_is_the_lowest_rate_within_five_percent_of_the_best():
    # best mean 3.09 (0.8); 0.4's mean 3.02 is within 5%, 0.2's 2.55 not
    assert calibrate.knee_plateau(SWEEP)["plateau"] == 0.4


@pytest.mark.parametrize("spoil", [
    {"backlog": 2},                        # a queue at the close
    {"failed": 3},                         # chunks lost to refusals
    {"stopped": "the session ran out of work"},
    {"cpr": None},                         # nothing due
], ids=["backlog", "failed", "stopped", "no_cpr"])
def test_each_rule_alone_keeps_a_rate_off_the_knee(spoil):
    lines = [dict(p) for p in SWEEP]
    bad = dict(lines[2], **spoil)          # 0.1, order seed 1
    if bad.get("cpr") is None:
        del bad["cpr"]
    lines[2] = bad
    assert calibrate.knee_plateau(lines)["knee"] == 0.08


def test_one_stall_at_the_close_is_not_a_queue():
    lines = [dict(p) for p in SWEEP]
    lines[2] = dict(lines[2], backlog=1)
    assert calibrate.knee_plateau(lines)["knee"] == 0.1


def test_a_rate_sustained_above_one_that_is_not_is_no_knee():
    # 0.12 passes on both orders now, but 0.1 misses on one: the knee is
    # the highest rate below which every swept rate is sustained
    lines = [dict(p) for p in SWEEP]
    lines[5] = dict(lines[5], cpr=0.95)
    lines[3] = dict(lines[3], cpr=0.85)
    assert calibrate.knee_plateau(lines)["knee"] == 0.08


def test_a_stopped_point_counts_only_against_the_knee():
    lines = SWEEP + [{"rate": 1.2, "seed": 1, "stopped": "ran out of work"}]
    assert calibrate.knee_plateau(lines) == {"knee": 0.1, "plateau": 0.4}


def test_nothing_sustained_gives_no_knee():
    lines = [dict(p, cpr=0.5) for p in SWEEP]
    assert calibrate.knee_plateau(lines)["knee"] is None


def test_knee_mode_reads_sweep_files(tmp_path, monkeypatch, capsys):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_text("\n".join(json.dumps(p) for p in SWEEP[:6]) + "\n"
                 + json.dumps({"knee": 0.1, "plateau": 0.12}) + "\n")
    b.write_text("\n".join(json.dumps(p) for p in SWEEP[6:]) + "\n")
    monkeypatch.setattr(sys, "argv", ["calibrate.py", "knee", str(a),
                                      str(b)])
    assert calibrate.main() == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"knee": 0.1, "plateau": 0.4}


C = 0.75
K = "S4_r0.0_W7_bf16"


def test_backlog_counts_a_stalled_stream_and_a_long_wait():
    # a: playout from 1.0, chunk 2 due 1.75, 3 due 2.5, not ready by 3.0
    a = StreamRecord(0, 0.5, 7, [1.0, 1.6, 3.4], [K] * 3)
    # b: arrived 1.0, nothing ready by 3.0 (over FIRST_DUE_S)
    b = StreamRecord(1, 1.0, 7, [4.0], [K])
    assert calibrate.backlog([a, b], 3.0, C) == 2


def test_backlog_leaves_out_a_fresh_arrival_a_stream_ahead_and_one_done():
    fresh = StreamRecord(0, 2.5, 7, [], [])           # 0.5 s ago
    ahead = StreamRecord(1, 0.0, 9, [0.3, 0.6, 0.9, 1.2], [K] * 4)
    done = StreamRecord(2, 0.0, 2, [0.3, 0.6], [K] * 2)
    later = StreamRecord(3, 5.0, 7, [], [])           # not arrived yet
    assert calibrate.backlog([fresh, ahead, done, later], 3.0, C) == 0
