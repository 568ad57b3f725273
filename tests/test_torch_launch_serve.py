"""``python -m repro_torch.launch.serve`` against ``python -m
repro.launch.serve`` on the same arguments, on the CPU (``--device cpu``
for the port): the same exit code, the same error line, and the same
printed lines once what depends on timing is masked (numbers, the
fidelity each chunk got, whether it was on time) and the chunk lines,
whose order follows the timing, are sorted.

The argvs are the reference's three behaviours the port's flags must
follow: ``--context-backend`` without ``--real --batched`` stops with
the reference's error, ``--real --streams 0`` serves zero streams, and
``--real --lanes 2`` prints the lanes' placement (and, where a move
crossed devices, the measured moves; one host device here has none).
"""
import re
import sys

import pytest

pytest.importorskip("torch")

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

ARGVS = {
    "backend-without-batched": "--real --context-backend gather",
    "backend-under-sim": "--sim --context-backend=paged",
    "zero-streams": "--real --streams 0 --chunks 1",
    "two-lanes": "--real --lanes 2 --workload burst --streams 3 --chunks 1 "
                 "--arrival-scale 0.2",
}
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _run(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve.py"] + argv.split())
    try:
        mod.main()
        code = 0
    except SystemExit as e:
        code = e.code
    cap = capsys.readouterr()
    return code, cap.out, cap.err


def _masked(out):
    lines = []
    for line in out.splitlines():
        line = re.sub(r"fid=\S+", "fid=*", line)
        line = re.sub(r"\b(on-time|LATE)\b", "*", line)
        lines.append(_NUMBER.sub("#", line).rstrip())
    return sorted(lines)


@pytest.mark.parametrize("name", list(ARGVS))
def test_launcher_acts_as_the_reference(name, monkeypatch, capsys):
    argv = ARGVS[name]
    code, out, err = _run(jserve, argv, monkeypatch, capsys)
    t_code, t_out, t_err = _run(tserve, argv + " --device cpu", monkeypatch,
                                capsys)
    assert t_code == code
    if code:
        # argparse's usage lines list each parser's own flags; the error
        # line is the behaviour
        assert t_err.splitlines()[-1] == err.splitlines()[-1]
        assert "--context-backend only applies to --real --batched" in err
        return
    assert _masked(t_out) == _masked(out)
    if name == "two-lanes":
        assert "  devices: 1 visible, lanes -> ['default', 'default']" \
            in t_out.splitlines()
    if name == "zero-streams":
        assert t_out.count("stream ") == 0 and "real-sequential" in t_out
