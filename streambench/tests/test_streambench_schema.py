"""A whole run on the CPU: the last line's schema and the window's
arithmetic."""
import json

from harness import run_tiny

from streambench import run as R


def test_result_line_schema():
    res, checks = run_tiny(seed=2**35 + 3)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"chunks_per_s", "vbench", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    assert checks["chunks_compared"]["value"] >= 2


def test_refused_streams_count_as_failed():
    """A stream the program turns away at its front door stays in the
    yardstick: its chunks count as due and failed, its wait in the tail."""
    from repro_torch.sched_sim.frontdoor import AdmissionDecision

    def refuse_one(session):
        class Door:
            outcomes = {}
            waiting = False

            def on_arrival(self, view, t, est, sid):
                if sid == 1:
                    self.outcomes[sid] = "rejected"
                    return AdmissionDecision("reject", 0.0, 0.0)
                return AdmissionDecision("admit", 0.0, 0.0)

            def drain(self, view, now):
                return [], []

            def observe_chunk(self, *args, **kwargs):
                pass

            def stats(self):
                return {}
        session.front_door = Door()
    res, _ = run_tiny(seed=11, session_hook=refuse_one)
    assert res["failed"] > 0 and res["attempted"] >= res["failed"]


def test_forbidden_module_names_compare_whole():
    import sys
    sys.modules.setdefault("repro_torch_fake_mod", sys)
    assert R.forbidden_modules() == [] or "repro_torch" not in \
        R.forbidden_modules()
