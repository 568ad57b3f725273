"""What the benchmark loads: never JAX, Flax or the JAX package (top-level
names compared whole), and the reference nothing of the program."""
import subprocess
import sys

from streambench import run as R

SCRIPT = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
bad = sorted({{m.split('.')[0] for m in sys.modules}} & {names!r})
print(bad)
"""


def loaded(body, names):
    code = SCRIPT.format(root=str(R.ROOT), src=str(R.ROOT / "src"),
                         body=body, names=set(names))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_nothing_of_the_program():
    body = "import streambench.reference.ardit"
    assert loaded(body, ["repro_torch", "repro", "jax"]) == "[]"


def test_a_whole_cpu_run_loads_no_jax():
    body = ("import torch; torch.set_num_threads(1)\n"
            "sys.path.insert(0, {!r})\n"
            "from harness import run_tiny\n"
            "run_tiny(seconds=1.0)").format(str(R.ROOT / "streambench"
                                                / "tests"))
    assert loaded(body, R.FORBIDDEN) == "[]"


def test_forbidden_compares_top_level_names_whole():
    assert "repro" in R.FORBIDDEN and "repro_torch" not in R.FORBIDDEN
