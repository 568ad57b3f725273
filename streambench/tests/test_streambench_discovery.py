"""Cells, configurations, traffic mixes and metric readers found by name
from BENCHMARK.json, and the configuration files against the program's."""
import dataclasses
import json

import pytest

from streambench import run as R
from streambench.lib import bench

BENCH = bench.load_bench(R.ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    c = bench.cell(R.ROOT, name)
    assert c.config["limits"]["assembly_faults"] == 0
    assert all(c.config["limits"][k] is not None for k in c.config["limits"])
    assert c.traffic["rate"] > 0 and "order_seed" in c.traffic
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert all(m["moves"] in names for m in c.per_layer)


@pytest.mark.parametrize("name", METRICS)
def test_reader_found(name):
    assert callable(bench.reader(name))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_is_the_source_but_what_reduced_lists(entry):
    """Every size the file states as its source's (``published``) is the
    one it runs, but the keys that ``reduced`` lists, and every key of the
    program's ``ModelConfig`` it sets is one the program takes."""
    from repro_torch.configs.base import ModelConfig
    cfg = json.loads((R.ROOT / entry["file"]).read_text())
    for k, v in cfg["published"].items():
        assert (cfg[k] != v) == (k in entry["reduced"]), k
    assert set(entry["reduced"]) <= set(cfg["published"])
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert {"n_layers", "d_model", "ardit_frame_tokens"} <= fields


def test_self_forcing_is_480p():
    """832x480 through Wan2.1's 8x VAE and 2x2 patches: 30 x 52 tokens a
    latent frame; umT5's 512 text tokens."""
    cfg = json.loads((R.ROOT / "streambench/configs/ardit-self-forcing.json")
                     .read_text())["published"]
    assert cfg["ardit_frame_tokens"] == (480 // 16) * (832 // 16)
    assert cfg["cond_tokens"] == 512


def test_metric_lists_follow_the_moves_rule():
    """A cell reports each per-layer metric only with the end-to-end metric
    it moves."""
    for name in CELLS:
        c = bench.cell(R.ROOT, name)
        moved = {m["name"] for m in c.end_to_end}
        assert {m["moves"] for m in c.per_layer} <= moved
