"""Serving executor base: the model, its parameters and the measured
latency EMAs the control plane re-profiles from.

The reference's sequential whole-chunk path (``generate_chunk`` over
``ardit.serve_chunk``, ``SequentialChunkExecutor``, ``serve_session``)
waits for its slice (ROADMAP); ``ChunkExecutor`` here is the base of the
batched executor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import ardit as A
from repro_torch.models.convert import params_to

# blend of the prior vs the newest measured latency in the online
# re-profiling EMAs (shared with the batched executor)
EMA_DECAY = 0.7


@dataclasses.dataclass
class ServedStream:
    sid: int
    cond: Any
    cache: Optional[Dict[str, Any]]
    target_chunks: int
    chunks: List[torch.Tensor] = dataclasses.field(default_factory=list)
    fidelity_log: List[str] = dataclasses.field(default_factory=list)
    next_deadline: float = 0.0
    chunk_seconds: float = 0.75

    @property
    def done(self) -> bool:
        return len(self.chunks) >= self.target_chunks


def param_generator(seed: int) -> torch.Generator:
    """CPU generator the executor draws fresh parameters from (the
    reference seeds ``init_params`` with ``PRNGKey(seed)``)."""
    return torch.Generator().manual_seed(seed)


class ChunkExecutor:
    """Holds one model on one device and its measured latency EMAs
    (online re-profiling).  ``device`` defaults to the card; without one
    the first allocation raises, as torch does — pass ``device="cpu"``
    to run on the host."""

    def __init__(self, cfg: Optional[ModelConfig] = None,
                 params: Optional[Any] = None, seed: int = 0,
                 device: Any = "cuda"):
        self.cfg = cfg or get_config("ardit-self-forcing").reduced()
        self.device = torch.device(device)
        self.params = (params_to(params, self.device) if params is not None
                       else A.init_params(self.cfg, param_generator(seed),
                                          self.device))
        self.latency_ema: Dict[str, float] = {}
