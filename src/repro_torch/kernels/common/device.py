"""The card's properties that the kernels' wrappers size their grids by."""
from __future__ import annotations

from typing import Dict

import torch

_SM_COUNT: Dict[int, int] = {}


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of ``dev`` (the current device when it
    has no index), read once per device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]
