"""The harness, driven by ``BENCHMARK.json``.

A cell names a configuration (``configs[].file``) and a traffic mix
(``streambench/traffic/<traffic>.json``); each metric is a reader in
``streambench/metrics/<name>.py`` with ``read(ctx) -> float | None``.  A
cell reports the end-to-end metrics whose ``workloads`` name it (all cells
without the key), and in a traced run the per-layer metrics whose
``workloads`` name it (without the key: every cell that reports the metric
they move).  Adding a configuration, a traffic mix, a cell or a metric is
adding files and an entry; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parents[1]          # streambench/


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_bench(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str, bench: Optional[Dict] = None) -> Cell:
    bench = bench or load_bench(root)
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / c["file"]).read_text())
    traffic = json.loads((PKG / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name, config, traffic, int(w["chips"]), e2e, layer)


def reader(name: str):
    """The ``read`` function of ``streambench/metrics/<name>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"streambench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[Dict], ctx: Any) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
