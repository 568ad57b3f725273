"""The kernel build's library name covers every header a source reaches.

``build._target`` names a library by a hash of its source, the headers
it includes with ``#include "..."`` (beside it, or in the shared
``kernels/common/csrc``), transitively, and the nvcc flags, so an edited
header rebuilds the libraries that include it.  Runs on the CPU: no
nvcc is needed to compute a name.
"""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fp8_matmul import ops as fp8_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

HOPPER = build.COMMON / "hopper.cuh"


@pytest.mark.parametrize("src,uses_hopper", [
    (flash_ops.SOURCE, True), (fp8_ops.SOURCE, True),
    (paged_ops.SOURCE, True), (paged_ops.DECODE_SOURCE, True),
    (ssd_ops.SOURCE, True)])
def test_sources_lists_the_shared_header(src, uses_hopper):
    found = build.sources(src)
    assert found[0] == src.resolve()
    assert (HOPPER.resolve() in found) == uses_hopper


def test_editing_a_header_changes_the_target(tmp_path):
    # a copy of a kernel source with the shared header beside it, and a
    # second header that the first one includes
    src = tmp_path / "flash_mha.cu"
    shutil.copy(flash_ops.SOURCE, src)
    header = tmp_path / "hopper.cuh"
    shutil.copy(HOPPER, header)
    inner = tmp_path / "inner.cuh"
    inner.write_text("#pragma once\n")
    header.write_text(header.read_text() + '\n#include "inner.cuh"\n')
    assert build.sources(src) == [src.resolve(), header.resolve(),
                                  inner.resolve()]
    first = build._target(src)
    assert first == build._target(src)            # deterministic
    header.write_text(header.read_text() + "// edited\n")
    second = build._target(src)
    assert second != first
    inner.write_text("#pragma once\n// edited\n")   # reached transitively
    assert build._target(src) not in (first, second)
    assert build._target(src).parent == build.build_dir()


def test_the_common_header_is_found_from_any_directory(tmp_path):
    # a source whose directory lacks the header takes the shared one
    src = tmp_path / "k.cu"
    src.write_text('#include "hopper.cuh"\n#include "missing.cuh"\n')
    assert build.sources(src) == [src.resolve(), HOPPER.resolve()]
    (tmp_path / "hopper.cuh").write_text("// a local one wins\n")
    assert build.sources(src) == [src.resolve(),
                                  (tmp_path / "hopper.cuh").resolve()]
