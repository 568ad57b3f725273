"""A run of the harness on the CPU at the reduced configuration."""
import json
import time
from pathlib import Path

from streambench import run as R
from streambench.lib import bench

HERE = Path(__file__).parent
TINY = json.loads((HERE / "ardit-tiny.json").read_text())
TINY_MIX = json.loads((HERE / "tiny-mix.json").read_text())


def tiny_cell(name="sf-saturate", trace=False):
    """``name``'s cell of BENCHMARK.json on the reduced configuration and a
    short, busy mix."""
    c = bench.cell(R.ROOT, name)
    return bench.Cell(name, TINY, TINY_MIX, c.chips, c.end_to_end,
                      c.per_layer)


def run_tiny(seed=7, seconds=2.0, session_hook=None, name="sf-saturate"):
    args = R.parse(["--workload", name, "--seed", str(seed),
                    "--seconds", str(seconds), "--trace", "0"])
    return R.run(args, device="cpu", cell=tiny_cell(name),
                 session_hook=session_hook, t_process=time.perf_counter())
