"""The port's test files skip, rather than error, where torch is missing.

A job that installs the reference's dependencies and not torch (the
repo's CI does) must still collect every ``tests/test_torch_*.py``
file: one import error stops a whole pytest run.  So each such file
calls ``pytest.importorskip("torch")`` before its first import of
``torch`` or ``repro_torch``.  This file needs no torch itself:

* each port test file, parsed with ``ast``: the first top-level import
  of ``torch`` or ``repro_torch`` comes after a top-level
  ``pytest.importorskip("torch")``;
* the port's test files collected in a fresh interpreter with torch
  masked out (``sys.modules["torch"] = None``): no collection error, and
  every file that imports torch is reported skipped.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

TESTS = pathlib.Path(__file__).resolve().parent
PORT_TESTS = sorted(TESTS.glob("test_torch_*.py"))
TORCH_ROOTS = ("torch", "repro_torch")


def _imports_torch(node):
    if isinstance(node, ast.Import):
        return any(a.name.split(".")[0] in TORCH_ROOTS for a in node.names)
    if isinstance(node, ast.ImportFrom):
        return node.level == 0 and node.module is not None \
            and node.module.split(".")[0] in TORCH_ROOTS
    return False


def _skips_without_torch(node):
    call = node.value if isinstance(node, (ast.Expr, ast.Assign)) else None
    return isinstance(call, ast.Call) \
        and isinstance(call.func, ast.Attribute) \
        and call.func.attr == "importorskip" \
        and isinstance(call.func.value, ast.Name) \
        and call.func.value.id == "pytest" \
        and [getattr(a, "value", None) for a in call.args] == ["torch"]


def _first_torch_import(path):
    body = ast.parse(path.read_text()).body
    for i, node in enumerate(body):
        if _imports_torch(node):
            return i, body
    return None, body


def test_the_port_has_test_files():
    assert len(PORT_TESTS) > 30


@pytest.mark.parametrize("path", PORT_TESTS, ids=[p.name for p in PORT_TESTS])
def test_skip_comes_before_the_first_torch_import(path):
    i, body = _first_torch_import(path)
    if i is None:                      # the file never imports torch
        return
    assert any(_skips_without_torch(n) for n in body[:i]), (
        f"{path.name}: pytest.importorskip('torch') must come before line "
        f"{body[i].lineno}")


def test_collection_without_torch_skips_the_port_files():
    need = [p for p in PORT_TESTS if _first_torch_import(p)[0] is not None]
    code = ("import sys; sys.modules['torch'] = None; import pytest; "
            "sys.exit(pytest.main(sys.argv[1:]))")
    env = dict(os.environ)
    src = str(TESTS.parent / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--collect-only", "-q", "-rs",
         "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly",
         *map(str, PORT_TESTS)],
        cwd=TESTS.parent, env=env, capture_output=True, text=True,
        timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "during collection" not in out and not any(
        ln.startswith("ERROR") for ln in out.splitlines()), out[-3000:]
    skipped = [ln for ln in out.splitlines() if ln.startswith("SKIPPED")
               and "could not import 'torch'" in ln]
    assert len(skipped) == len(need), out[-3000:]
