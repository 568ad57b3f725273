"""Lane pool: the apply layer between the control plane and the
executors.

A *lane* is one execution slot over a device — one
``BatchedChunkExecutor`` with its own paged ``KVPool``, or one
``SequentialChunkExecutor`` — standing in for one Worker of the paper's
cluster (SS3.1).  This port serves ONE lane:
the cross-lane mechanisms of the reference (real KV migrations, elastic
SP2 head splits and batch-axis borrows, heterogeneous model bundles)
wait for the multi-lane slice, and their apply methods raise
``NotImplementedError``.  A one-lane session never calls them: with a
single worker the control plane plans no re-homing and no SP.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.state_plane import AsyncTransferEngine
from repro_torch.core.types import Stream
from repro_torch.serve.batcher import BatchedChunkExecutor

_MULTI_LANE = ("multi-lane serving (migrations, elastic SP) waits for its "
               "slice (ROADMAP: port queue)")


class LanePool:
    """One ``BatchedChunkExecutor`` per lane + the decision apply layer.

    ``lane_of`` maps every admitted stream to its home lane.  Counters
    (``n_migrations``, ``n_sp_expands``, ``n_sp_releases``) record
    decisions actually *applied*; they stay 0 on one lane.
    """

    def __init__(self, n_lanes: int = 1, cfg: Any = None, params: Any = None,
                 seed: int = 0, max_streams: int = 16,
                 context_backend: str = "paged",
                 engine: Optional[AsyncTransferEngine] = None,
                 page_evict: bool = False, device: Any = "cuda"):
        if n_lanes != 1:
            raise NotImplementedError(_MULTI_LANE)
        first = BatchedChunkExecutor(cfg=cfg, params=params, seed=seed,
                                     max_streams=max_streams,
                                     context_backend=context_backend,
                                     engine=engine, device=device,
                                     page_evict=page_evict)
        self._init([first], first.pool.engine)

    @classmethod
    def wrap(cls, executor: Any) -> "LanePool":
        """Single-lane pool around an existing executor (the session's
        ``executor=`` injection; also adapts the sequential whole-chunk
        executor, which has no page pool)."""
        self = cls.__new__(cls)
        pool = getattr(executor, "pool", None)
        self._init([executor],
                   pool.engine if pool is not None else executor.engine)
        return self

    def _init(self, executors: List[Any], engine: AsyncTransferEngine):
        self.executors = executors
        self.engine = engine
        self.lane_of: Dict[int, int] = {}
        self.n_migrations = 0
        self.n_sp_expands = 0
        self.n_sp_releases = 0

    # ---- views -------------------------------------------------------------
    @property
    def n_lanes(self) -> int:
        return len(self.executors)

    def ex(self, lane: int) -> Any:
        return self.executors[lane]

    @property
    def all_executors(self) -> List[Any]:
        return self.executors

    def executor_of(self, sid: int) -> Any:
        return self.executors[self.lane_of.get(sid, 0)]

    def chunks_of(self, sid: int) -> List[Any]:
        return self.executor_of(sid).chunks.get(sid, [])

    def is_inflight(self, sid: int) -> bool:
        return sid in self.executor_of(sid).inflight

    def any_inflight(self) -> bool:
        return any(ex.inflight for ex in self.executors)

    def remaining_estimate(self, sid: int) -> float:
        return self.executor_of(sid).remaining_estimate(sid)

    def latency_ema_get(self, key: str, default: float) -> float:
        """Measured chunk-latency EMA for a fidelity, averaged over the
        lanes that have observed it."""
        vals = [ex.latency_ema[key] for ex in self.executors
                if key in ex.latency_ema]
        return sum(vals) / len(vals) if vals else default

    # ---- stream lifecycle (routed to the home lane) ------------------------
    def admit(self, sid: int, lane: int, seed: int = 0,
              streams: Optional[Dict[int, Stream]] = None,
              protect: Sequence[int] = ()) -> bool:
        self.lane_of[sid] = lane
        return self.executors[lane].admit(sid, seed=seed, streams=streams,
                                          protect=protect)

    def ensure_resident(self, sid: int,
                        streams: Optional[Dict[int, Stream]] = None,
                        protect: Sequence[int] = ()) -> bool:
        return self.executor_of(sid).ensure_resident(sid, streams,
                                                     protect=protect)

    def abort_chunk(self, sid: int) -> None:
        self.executor_of(sid).abort_chunk(sid)

    def reset_condition(self, sid: int, seed: int) -> bool:
        """Prompt switch: fresh cond encode + sink rewrite on the home
        lane."""
        return self.executor_of(sid).reset_condition(sid, seed)

    def retire(self, sid: int) -> None:
        self.executor_of(sid).retire(sid)

    # ---- cross-lane decisions (multi-lane slice) ---------------------------
    def migrate(self, sid: int, src: int, dst: int, *,
                cross_node: bool = False) -> bool:
        raise NotImplementedError(_MULTI_LANE)

    def sp_expand(self, sid: int, donor: int,
                  streams: Optional[Dict[int, Stream]] = None) -> bool:
        raise NotImplementedError(_MULTI_LANE)

    def sp_release(self, sid: int) -> None:
        raise NotImplementedError(_MULTI_LANE)

    def prejit_sp(self, extents: Sequence[int] = (0, 1, 2)) -> None:
        raise NotImplementedError(_MULTI_LANE)
