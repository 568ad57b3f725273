"""Build a ``csrc`` CUDA source into a shared library and load it.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` over a source with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  A source
includes its headers with ``#include "..."``, found beside the including
file or in ``common/csrc`` (the shared Hopper header, passed with
``-I``).  The library lands in ``_build/`` next to this file (or
``$REPRO_TORCH_BUILD_DIR``), named by a hash of the source, every header
it reaches and the flags, so an edited source or header rebuilds and
concurrent builds never see a half-written file.  A missing ``nvcc`` or
a failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

# headers shared by the kernels of several subpackages
COMMON = Path(__file__).resolve().parent / "common" / "csrc"
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_LOADED: Dict[str, ctypes.CDLL] = {}
# nvcc output (with ptxas register / shared-memory / spill counts) of
# every library built by this process, by source path
BUILD_LOGS: Dict[str, str] = {}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               Path(__file__).resolve().parent / "_build"))


def nvcc() -> str:
    """Path of nvcc: ``$PATH`` first, then the CUDA toolkit's default
    install location.  Raises when neither has it."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.access(default, os.X_OK):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built at first use and need the CUDA toolkit")


def sources(src: Path) -> List[Path]:
    """``src`` and every header it reaches through ``#include "..."``,
    transitively, each looked up beside the file that includes it, then
    in ``COMMON``; in the order first reached."""
    seen: List[Path] = []
    todo = [Path(src).resolve()]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        for name in _INCLUDE.findall(f.read_text()):
            for d in (f.parent, COMMON):
                if (d / name).is_file():
                    todo.append((d / name).resolve())
                    break
    return seen


def _target(src: Path) -> Path:
    h = hashlib.sha1()
    for f in sources(src):
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:12]}.so"


def _compile(src: Path):
    """Start one nvcc process into a temporary file beside the target;
    returns (process, temporary path, target path)."""
    out = _target(src)
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(COMMON), "-o", tmp,
         str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(sources: Sequence[Path]) -> List[Path]:
    """Compile every source whose library is missing, one nvcc each, all
    started together; returns the library paths.  Raises on the first
    failed build with nvcc's output."""
    started = [(Path(s), *_compile(Path(s))) for s in sources
               if not _target(Path(s)).exists()]
    failed = []
    for src, proc, tmp, out in started:
        log, _ = proc.communicate()
        BUILD_LOGS[str(src)] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{src}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [_target(Path(s)) for s in sources]


def load(src: Path) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    key = str(src)
    lib = _LOADED.get(key)
    if lib is None:
        path, = build([src])
        lib = _LOADED[key] = ctypes.CDLL(str(path))
    return lib
