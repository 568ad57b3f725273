"""The port's lowering (``repro_torch.launch.{lowering, analysis}``)
against the reference's small-mesh lowering cells
(``tests/test_sharding.py::TestSmallMeshLowering``), both run here.

The reference lowers and compiles each cell on a 1x1 mesh whose axes
are ``Auto``, built in this test (under jax 0.9 ``jax.make_mesh``
defaults to ``Explicit`` axes, with which its
``with_sharding_constraint`` refuses to lower); the port traces on a
1x1 mesh of a fake one-rank process group.  Each side is lowered once
per module.

* Per-device FLOPs equal the reference's exactly (``hlo_cost.
  analyze_text`` of the compiled HLO against the port's dispatch count:
  both count every product once at 2MNK on one device).
* Argument bytes equal the reference's exactly
  (``memory_analysis().argument_size_in_bytes``: for the train cells
  the params, the two fp32 moments, the int32 step and the batch,
  minitron-8b 2,366,724), plus the arguments the reference's ``jit``
  drops as unused (``keep_unused=False``; mamba2-780m's decode does not
  read ``pos``), which the port's eager call still takes.
* ``model_flops`` equals the reference's for every config and shape.
* qwen1.5-32b at ``long_500k`` is skipped with the reference's reason.
"""
import dataclasses

import jax
import pytest
from jax.sharding import AxisType

pytest.importorskip("torch")

from torch.distributed.device_mesh import init_device_mesh

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_get_config
from repro.launch import analysis as janalysis
from repro.launch import hlo_cost as jhlo_cost
from repro.launch import lowering as jlowering
from repro_torch.configs.base import SHAPES, ShapeConfig, get_config
from repro_torch.configs.base import list_archs
from repro_torch.launch import analysis
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.lowering import cell_config, fake_world, lower_cell

# the reference's six TestSmallMeshLowering cells (reduced configs;
# train ShapeConfig("t", "train", 32, 2), serving (..., 64, 2))
CELLS = [("minitron-8b", "train"), ("mamba2-780m", "train"),
         ("jamba-v0.1-52b", "train"), ("minitron-8b", "decode"),
         ("mamba2-780m", "decode"), ("whisper-medium", "prefill")]


def _shape(kind):
    return ("t", kind, 32 if kind == "train" else 64, 2)


_LOWERED = {}
_REFERENCE = {}


def _lowered(arch, kind):
    if (arch, kind) not in _LOWERED:
        with fake_world(1):
            mesh = init_device_mesh("cpu", (1, 1),
                                    mesh_dim_names=("data", "model"))
            _LOWERED[(arch, kind)] = lower_cell(
                get_config(arch).reduced(), mesh, ShapeConfig(*_shape(kind)))
    return _LOWERED[(arch, kind)]


def _reference(arch, kind):
    """(per-device FLOPs, argument bytes, bytes of the arguments its
    ``jit`` dropped as unused) of the reference's compiled cell on a 1x1
    mesh with ``Auto`` axes."""
    if (arch, kind) not in _REFERENCE:
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        lowered = jlowering.lower_cell(
            jax_get_config(arch).reduced(), mesh,
            JShapeConfig(*_shape(kind)))
        kept = set(lowered._lowering.compile_args["kept_var_idx"])
        avals = [a._aval for a in jax.tree_util.tree_leaves(
            lowered.args_info)]
        dropped = sum(a.size * a.dtype.itemsize
                      for i, a in enumerate(avals) if i not in kept)
        compiled = lowered.compile()
        _REFERENCE[(arch, kind)] = (
            jhlo_cost.analyze_text(compiled.as_text()).flops,
            compiled.memory_analysis().argument_size_in_bytes, dropped)
    return _REFERENCE[(arch, kind)]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flops_equal_reference(arch, kind):
    lo = _lowered(arch, kind)
    want = _reference(arch, kind)[0]
    assert want > 0
    assert lo.flops == want, (lo.flops, want)
    assert lo.coll_bytes == 0                  # one device: no collective
    assert lo.heads_replicated == 0


@pytest.mark.parametrize("arch,kind", CELLS)
def test_argument_bytes_exact(arch, kind):
    lo = _lowered(arch, kind)
    _, want, dropped = _reference(arch, kind)
    assert lo.argument_bytes == want + dropped, (lo.argument_bytes, want,
                                                 dropped)
    if (arch, kind) == ("minitron-8b", "train"):
        assert lo.argument_bytes == 2_366_724
    # only mamba2-780m's decode leaves an argument unread: pos, int32 [2]
    assert dropped == (8 if (arch, kind) == ("mamba2-780m", "decode")
                       else 0)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(list_archs()))
def test_model_flops_match_reference(arch, shape):
    jcfg = jlowering.cell_config(jax_get_config(arch), JSHAPES[shape])
    cfg = cell_config(get_config(arch), SHAPES[shape])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert analysis.model_flops(cfg, SHAPES[shape]) == \
        janalysis.model_flops(jcfg, JSHAPES[shape])
    assert analysis.active_params(cfg) == janalysis.active_params(jcfg)


def test_roofline_terms():
    lo = _lowered("minitron-8b", "train")
    roof = analysis.analyze(lo, 1)
    assert roof.flops == lo.flops and roof.n_chips == 1
    assert roof.t_compute == lo.flops / analysis.PEAK_FLOPS
    assert roof.t_memory == lo.hbm_bytes / analysis.HBM_BW
    assert roof.t_collective == 0.0
    assert roof.dominant in ("compute", "memory")
    assert roof.row()["dominant"] == roof.dominant


def test_long_500k_skipped_with_reference_reason():
    rec = run_cell("qwen1.5-32b", "long_500k", verbose=False, save=False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == ("long_500k needs sub-quadratic attention "
                             "(DESIGN.md SS4); windowed adaptation lowered "
                             "separately")


@pytest.mark.parametrize("arch", ["minitron-8b", "whisper-medium"])
def test_split_sequence_decode_moves_no_cache(arch):
    """Four KV heads over a fake (1, 8) mesh do not divide, so
    ``cache_shardings`` splits the caches' slots over ``model``: a decode
    step's collectives (the token's K/V, the query, partial softmax
    statistics, the activations) are the same bytes at 64 and at 256
    cached tokens: the cache is never gathered."""
    coll = []
    for seq in (64, 256):
        with fake_world(8):
            mesh = init_device_mesh("cpu", (1, 8),
                                    mesh_dim_names=("data", "model"))
            lo = lower_cell(get_config(arch).reduced(), mesh,
                            ShapeConfig("t", "decode", seq, 2))
        coll.append(lo.coll_by_op)
    assert coll[0] == coll[1], coll
