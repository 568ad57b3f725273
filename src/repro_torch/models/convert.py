"""Carry the JAX reference's parameters across to the port.

``params_from_numpy`` takes the reference ``ardit`` params as a nested
dict of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``)
and returns the same tree of torch tensors, keeping the stacked
``[L, ...]`` layer layout.  bf16 and fp8 arrays arrive as ``ml_dtypes``
numpy arrays, which ``torch.from_numpy`` refuses, so they cross as raw
bits (``uint16`` / ``uint8``) and are reinterpreted on the torch side.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

_BIT_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        return torch.from_numpy(a.view(view[0]).copy()).view(view[1])
    return torch.from_numpy(a.copy())


def params_from_numpy(tree: Any) -> Any:
    """Nested dict of numpy arrays -> nested dict of CPU tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree))


def params_to(tree: Any, device) -> Any:
    """The same tree with every tensor on ``device`` (no copy where it
    already lives there)."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)
