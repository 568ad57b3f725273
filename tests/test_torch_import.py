"""The port stands alone: importing ``repro_torch`` (down to its serving
session) pulls in no ``jax`` and nothing of the JAX reference package,
no source file of the port or ``chip_smoke.py`` imports either, nothing
is built at import time, and the entry points default to the card.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import sys
import repro_torch
import repro_torch.serve.session, repro_torch.launch.serve
import repro_torch.kernels.paged_attention
import repro_torch.kernels.flash_attention
import repro_torch.kernels.ssd_scan
import repro_torch.models.ssm, repro_torch.models.registry
import repro_torch.launch.profile_step, repro_torch.launch.profile_ssm
import repro_torch.sched_sim, repro_torch.sched_sim.calibration
import repro_torch.sched_sim.policies, repro_torch.serve.modelplane
import repro_torch.models.stepcache
import repro_torch.models.transformer, repro_torch.models.hybrid
import repro_torch.models.encdec, repro_torch.models.ardit
import repro_torch.data.pipeline, repro_torch.distributed.precision
import repro_torch.train.optimizer, repro_torch.train.loop
import repro_torch.train.checkpoint, repro_torch.launch.train
import repro_torch.kernels.common.grad, repro_torch.kernels.fp8_matmul
import repro_torch.distributed.sharding, repro_torch.train.compression
import repro_torch.launch.dryrun, repro_torch.launch.mesh
import repro_torch.configs.base as cb; cb.list_archs()
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'))
print('BAD', bad)
"""


def test_fresh_import_loads_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert "BAD []" in out, out


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax_or_reference(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.search(text), path


def test_no_kernel_built_at_import():
    from repro_torch.kernels import build
    assert not build._LOADED


def test_entry_points_default_to_the_card():
    """``BatchedChunkExecutor(cfg)``, and the Mamba-2, dense, MoE, VLM
    and hybrid families' ``init_params`` and ``init_cache`` through the
    registry, without ``device`` allocate on the card; on a host without
    one they raise, as torch does — nothing quietly falls back to the
    CPU.  ``launch/train.py`` trains on the card unless ``--device cpu``
    is given, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs.base import get_config
    from repro_torch.serve.batcher import BatchedChunkExecutor
    from repro_torch.serve.session import SessionConfig
    cfg = get_config("ardit-self-forcing").reduced()
    with pytest.raises((AssertionError, RuntimeError)):
        BatchedChunkExecutor(cfg)
    assert SessionConfig().device == "cuda"
    from repro_torch.launch import train
    assert train.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--steps", "1"])
    from repro_torch.models import registry
    mcfg = get_config("mamba2-780m").reduced()
    api = registry.get_api(mcfg)
    with pytest.raises((AssertionError, RuntimeError)):
        api.init(mcfg, torch.Generator().manual_seed(0))
    with pytest.raises((AssertionError, RuntimeError)):
        api.init_cache(mcfg, 2, 16)
    for arch in ("minitron-8b", "granite-moe-1b-a400m", "internvl2-26b",
                 "jamba-v0.1-52b"):
        rcfg = get_config(arch).reduced()
        api = registry.get_api(rcfg)
        with pytest.raises((AssertionError, RuntimeError)):
            api.init(rcfg, torch.Generator().manual_seed(0))
        with pytest.raises((AssertionError, RuntimeError)):
            api.init_cache(rcfg, 2, 16)
