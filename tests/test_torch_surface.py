"""The port does all that the JAX reference does: checked name by name.

(a) Every public top-level ``def``, ``class`` and module constant of
``src/repro/**/*.py``, and every public method of a public class, has a
counterpart of the same name in the same relative module of
``src/repro_torch`` (a name the port's module defines or imports), or
stands in ``JAX_ONLY`` with why JAX needs it and what the port uses
instead.  A ``JAX_ONLY`` entry whose name the port has gained, or the
reference has lost, fails the test, so the table cannot go stale.  The
Pallas modules (``kernels/*/kernel.py``) are held by (b) instead.
(b) Every function of ``src/repro/kernels/*/kernel.py`` that calls
``pl.pallas_call`` has a hand-written counterpart: the port's
``kernels/<name>/`` holds ``csrc/*.cu``, a plain version (``ref.py``)
and an ``ops`` module with a path chooser, and ``chip_smoke.py`` names
the function's ``file:line`` in a kernel's ``replaces``.
(c) Every option of the reference's launchers is an option of the port's
launcher of the same name (its parser built, not grepped).

(a) and (b) parse both trees with ``ast`` and import neither.
"""
import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# qualified reference name -> (why JAX needs it, what the port uses
# instead, the port's name for that replacement)
JAX_ONLY = {
    "configs/base.py::jax_key": (
        "the default jax.random.PRNGKey(0) for an init: JAX draws only from "
        "explicit keys",
        "a torch.Generator seeded by the caller, passed to every init",
        "models/layers.py::dense_init"),
    "models/layers.py::split_keys": (
        "jax.random.split: every sub-init needs a key of its own",
        "one torch.Generator whose state advances with each draw; stacks "
        "are filled one layer at a time from it",
        "models/layers.py::init_stacked"),
    "models/registry.py::Sds": (
        "jax.ShapeDtypeStruct, the abstract inputs jit lowers against",
        "tensors on torch's meta device (shape and dtype, no storage)",
        "models/registry.py::input_specs"),
    "serve/lanes.py::LanePool.prejit_sp": (
        "warms jit's compile caches for the SP2 head-split step, so an "
        "expansion never compiles mid-burst",
        "eager dispatch: the head-split step runs as it is called, with "
        "nothing to compile",
        "models/ardit.py::denoise_step_paged_sp"),
    "launch/hlo_cost.py::OpLine": (
        "one instruction of the compiled HLO text",
        "the dispatcher's count of the aten ops one rank runs (no HLO)",
        "launch/hlo_cost.py::DispatchCost"),
    "launch/hlo_cost.py::Computation": (
        "one computation of the compiled HLO text",
        "the dispatcher's count of the aten ops one rank runs (no HLO)",
        "launch/hlo_cost.py::DispatchCost"),
    "launch/hlo_cost.py::parse_module": (
        "parses XLA's HLO text into computations",
        "the dispatcher's count of the aten ops one rank runs (no HLO)",
        "launch/hlo_cost.py::DispatchCost"),
    "launch/hlo_cost.py::analyze_text": (
        "FLOPs and bytes read off HLO text",
        "``hlo_cost.analyze``, which runs the step under the dispatcher's "
        "count",
        "launch/hlo_cost.py::DispatchCost"),
    "launch/hlo_cost.py::top_ops": (
        "the largest contributors by HLO instruction",
        "collective bytes by op kind (``HloCost.coll_by_op``) from the "
        "dispatcher's count",
        "launch/hlo_cost.py::DispatchCost"),
    "launch/analysis.py::ICI_BW": (
        "the TPU's inter-chip link rate, the collective term's divisor",
        "the H100's NVLink rate",
        "launch/analysis.py::LINK_BW"),
    "launch/analysis.py::collective_bytes": (
        "collective bytes summed off HLO text",
        "the functional collectives' result bytes, counted at the "
        "dispatcher",
        "launch/hlo_cost.py::DispatchCost"),
}


def _top_level(body):
    """Statements at module level, through ``if`` / ``try`` blocks."""
    for node in body:
        yield node
        if isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body + node.orelse + node.finalbody
                                  + [s for h in node.handlers
                                     for s in h.body])


def _targets(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
        for e in elts:
            if isinstance(e, ast.Name):
                yield e.id


def defined_names(path, imports=False):
    """Public names a module defines: top-level functions, classes and
    constants, and ``Class.method`` for each public method of a public
    class; with ``imports``, also the names its imports bind."""
    names = set()
    for node in _top_level(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            if not node.name.startswith("_"):
                names |= {f"{node.name}.{f.name}" for f in node.body
                          if isinstance(f, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_targets(node))
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0]
                      for a in node.names}
    return {n for n in names if not n.split(".")[-1].startswith("_")}


def missing_names(ref_root, port_root):
    """``module::name`` for each public reference name without a
    counterpart in the port's module of the same relative path."""
    missing = set()
    for path in sorted(ref_root.rglob("*.py")):
        rel = path.relative_to(ref_root)
        if rel.parts[0] == "kernels" and rel.name == "kernel.py":
            continue                              # Pallas: check (b)
        counterpart = port_root / rel
        port = (defined_names(counterpart, imports=True)
                if counterpart.exists() else set())
        missing |= {f"{rel.as_posix()}::{n}"
                    for n in defined_names(path) - port}
    return missing


def surface_problems(ref_root, port_root, table):
    """What check (a) reports: names neither ported nor in ``table``,
    stale entries of ``table``, and replacements the port lacks."""
    missing = missing_names(ref_root, port_root)
    problems = [f"no counterpart, not in JAX_ONLY: {n}"
                for n in sorted(missing - set(table))]
    problems += [f"stale JAX_ONLY entry (the port has it or the reference "
                 f"lost it): {n}" for n in sorted(set(table) - missing)]
    for name, (why, instead, replacement) in sorted(table.items()):
        module, attr = replacement.split("::")
        path = port_root / module
        if not (why and instead and path.exists()
                and attr in defined_names(path)):
            problems.append(f"{name}: replacement {replacement} is not in "
                            f"the port")
    return problems


def test_every_public_name_has_a_counterpart_or_a_reason():
    assert surface_problems(REF, PORT, JAX_ONLY) == []


def test_the_checker_reports_a_missing_name_and_a_stale_entry(tmp_path):
    ref, port = tmp_path / "ref" / "pkg", tmp_path / "port" / "pkg"
    ref.mkdir(parents=True)
    port.mkdir(parents=True)
    (ref / "mod.py").write_text(
        "LIMIT = 3\n_PRIVATE = 1\n\ndef kept():\n    pass\n\n"
        "def dropped():\n    pass\n\nclass Pool:\n    def alloc(self):\n"
        "        pass\n\n    def warm(self):\n        pass\n\n"
        "    def _helper(self):\n        pass\n")
    (port / "mod.py").write_text(
        "from os.path import join as kept\nLIMIT = 3\n\nclass Pool:\n"
        "    def alloc(self):\n        pass\n\ndef replacement():\n"
        "    pass\n")
    (ref / "gone.py").write_text("def only_here():\n    pass\n")
    assert missing_names(ref.parent, port.parent) == {
        "pkg/mod.py::dropped", "pkg/mod.py::Pool.warm",
        "pkg/gone.py::only_here"}
    table = {n: ("why", "instead", "pkg/mod.py::replacement")
             for n in ("pkg/mod.py::dropped", "pkg/mod.py::Pool.warm",
                       "pkg/gone.py::only_here")}
    assert surface_problems(ref.parent, port.parent, table) == []
    # a name with no entry is reported
    partial = {k: v for k, v in table.items() if k != "pkg/mod.py::dropped"}
    assert surface_problems(ref.parent, port.parent, partial) == [
        "no counterpart, not in JAX_ONLY: pkg/mod.py::dropped"]
    # an entry the port has since gained is stale
    stale = {**table, "pkg/mod.py::LIMIT": ("why", "instead",
                                            "pkg/mod.py::replacement")}
    assert surface_problems(ref.parent, port.parent, stale) == [
        "stale JAX_ONLY entry (the port has it or the reference lost it): "
        "pkg/mod.py::LIMIT"]
    # a replacement the port does not define is reported
    wrong = {**table, "pkg/gone.py::only_here": ("why", "instead",
                                                 "pkg/mod.py::nowhere")}
    assert surface_problems(ref.parent, port.parent, wrong) == [
        "pkg/gone.py::only_here: replacement pkg/mod.py::nowhere is not in "
        "the port"]


def pallas_functions():
    """(kernel dir, function, line) of each module-level function of the
    reference's ``kernels/*/kernel.py`` that calls ``pallas_call``."""
    found = []
    for path in sorted(REF.glob("kernels/*/kernel.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.FunctionDef) and any(
                    isinstance(n, ast.Call)
                    and isinstance(n.func, (ast.Attribute, ast.Name))
                    and getattr(n.func, "attr", getattr(n.func, "id", None))
                    == "pallas_call" for n in ast.walk(node)):
                found.append((path.parent.name, node.name, node.lineno))
    return found


def chip_smoke_replaces():
    """The ``replaces`` values of ``chip_smoke.py``'s kernel records."""
    out = set()
    for node in ast.walk(ast.parse((ROOT / "chip_smoke.py").read_text())):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "replaces" \
                        and isinstance(v, ast.Constant):
                    out.add(v.value)
    return out


def test_every_pallas_kernel_has_a_hopper_counterpart():
    found = pallas_functions()
    assert found, "no pallas_call found in the reference's kernels"
    replaces = chip_smoke_replaces()
    for kernel, fn, line in found:
        port = PORT / "kernels" / kernel
        assert list((port / "csrc").glob("*.cu")), f"{fn}: no CUDA source"
        assert (port / "ref.py").exists(), f"{fn}: no plain version"
        chooser = "decode_kernel_path" if "decode" in fn else "kernel_path"
        assert chooser in defined_names(port / "ops.py"), \
            f"{fn}: ops has no {chooser}"
        assert f"src/repro/kernels/{kernel}/kernel.py:{line}" in replaces, \
            f"{fn} ({kernel}/kernel.py:{line}) is in no chip_smoke record"


def reference_options(launcher):
    """The option strings of every ``add_argument`` call in the
    reference's ``launch/<launcher>.py``."""
    tree = ast.parse((REF / "launch" / f"{launcher}.py").read_text())
    return {a.value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)
            and str(a.value).startswith("-")}


@pytest.mark.parametrize("launcher", ["serve", "train", "dryrun"])
def test_every_reference_flag_is_a_port_option(launcher):
    want = reference_options(launcher)
    assert want, f"no options found in the reference's {launcher}.py"
    parser = importlib.import_module(
        f"repro_torch.launch.{launcher}").build_parser()
    have = {s for action in parser._actions for s in action.option_strings}
    assert sorted(want - have) == []
