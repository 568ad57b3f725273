"""Serving executors: the model, its parameters and the measured
latency EMAs the control plane re-profiles from.

``ChunkExecutor`` generates whole chunks one stream at a time
(``open_stream`` / ``generate_chunk`` over ``ardit.serve_chunk``: every
attention call goes through ``attention.mha``, the flash-attention
kernel on the card).  ``SequentialChunkExecutor`` exposes it through the
batched executor's step interface, so ``serve.session.StreamingSession``
drives either executor through one control loop.  It is also the base of
the batched executor (``serve.batcher``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.fidelity import FidelityConfig
from repro_torch.core.state_plane import AsyncTransferEngine
from repro_torch.core.types import Stream
from repro_torch.models import ardit as A
from repro_torch.models.convert import params_to
from repro_torch.profiler import trace

# blend of the prior vs the newest measured latency in the online
# re-profiling EMAs (shared with the batched executor)
EMA_DECAY = 0.7


def cond_noise(seed: int, d_model: int) -> torch.Tensor:
    """A stream's stub text-encoder output [1, COND_TOKENS, d_model]:
    N(0, 0.02^2) from a CPU generator seeded with ``1000 + seed`` (the
    reference draws ``jax.random.normal(PRNGKey(1000 + seed)) * 0.02``)."""
    g = torch.Generator().manual_seed((1000 + seed) & ((1 << 64) - 1))
    return torch.randn((1, A.COND_TOKENS, d_model), generator=g) * 0.02


def chunk_noise(chunk_seq: int, sid: int, tc: int) -> torch.Tensor:
    """Initial latents [1, tc, LATENT_CH] of a stream's chunk: N(0, 1)
    from a CPU generator seeded with ``chunk_seq * 7919 + sid`` (the
    reference's ``PRNGKey(chunk_seq * 7919 + sid)``)."""
    g = torch.Generator().manual_seed((chunk_seq * 7919 + sid)
                                      & ((1 << 64) - 1))
    return torch.randn((1, tc, A.LATENT_CH), generator=g)


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
    """Holds one model on one device, generates whole chunks, and feeds
    the measured wall latency back as the timing prior (online
    re-profiling).  ``device`` defaults to the card; without one the
    first allocation raises, as torch does — pass ``device="cpu"`` to run
    on the host."""

    def __init__(self, cfg: Optional[ModelConfig] = None,
                 params: Optional[Any] = None, seed: int = 0,
                 device: Any = "cuda"):
        self.cfg = cfg or get_config("ardit-self-forcing").reduced()
        self.device = torch.device(device)
        self.params = (params_to(params, self.device) if params is not None
                       else A.init_params(self.cfg, param_generator(seed),
                                          self.device))
        self.latency_ema: Dict[str, float] = {}

    def _sync(self) -> None:
        """Wait for the device: the latency clock must measure compute,
        not launch (the reference's ``block_until_ready``).  The idle
        card then anchors the tracer's device clock."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            trace.synced(self.device)

    def open_stream(self, sid: int, target_chunks: int, *,
                    now: float, ttfc_slack: float,
                    seed: int = 0) -> ServedStream:
        cond = cond_noise(seed, self.cfg.d_model).to(self.device)
        cache = A.init_cache(self.cfg, self.params, cond)
        return ServedStream(sid=sid, cond=cond, cache=cache,
                            target_chunks=target_chunks,
                            next_deadline=now + ttfc_slack)

    def generate_chunk(self, s: ServedStream, fidelity: FidelityConfig
                       ) -> Tuple[torch.Tensor, float]:
        noise = chunk_noise(len(s.chunks), s.sid,
                            A.chunk_tokens(self.cfg)).to(self.device)
        t0 = time.perf_counter()
        chunk, s.cache = A.serve_chunk(self.cfg, self.params, s.cache,
                                       noise, fidelity)
        self._sync()
        dt = time.perf_counter() - t0
        s.chunks.append(chunk)
        s.fidelity_log.append(fidelity.key)
        self.latency_ema[fidelity.key] = (
            EMA_DECAY * self.latency_ema.get(fidelity.key, dt)
            + (1.0 - EMA_DECAY) * dt)
        return chunk, dt


@dataclasses.dataclass
class _Flight:
    """One stream's pending chunk in the sequential adapter (the whole
    chunk is one atomic 'step')."""
    fidelity: FidelityConfig
    started: float = 0.0
    step: int = 0
    active_s: float = 0.0             # wall of the chunk's one step


class SequentialChunkExecutor(ChunkExecutor):
    """Whole-chunk-atomic adapter: exposes the batched executor's step
    interface (``admit`` / ``begin_chunk`` / ``run_step`` / ``retire``)
    over the one-stream-at-a-time path, so
    ``serve.session.StreamingSession`` drives either executor through
    ONE control loop.  Batch size is 1 and one ``run_step`` call
    generates one complete chunk."""

    def __init__(self, cfg: Optional[ModelConfig] = None,
                 params: Optional[Any] = None, seed: int = 0,
                 device: Any = "cuda"):
        super().__init__(cfg=cfg, params=params, seed=seed, device=device)
        self.streams: Dict[int, ServedStream] = {}
        self.inflight: Dict[int, _Flight] = {}
        self.chunks: Dict[int, List[torch.Tensor]] = {}
        self.fidelity_log: Dict[int, List[str]] = {}
        # no KV pool, so no spill/restore traffic: the engine exists
        # only to satisfy the shared metrics surface (empty log)
        self.engine = AsyncTransferEngine(n_layers=self.cfg.n_layers)

    def admit(self, sid: int, seed: int = 0,
              streams: Optional[Dict[int, Stream]] = None,
              protect: Sequence[int] = ()) -> bool:
        st = self.open_stream(sid, target_chunks=1 << 30, now=0.0,
                              ttfc_slack=0.0, seed=seed)
        self.streams[sid] = st
        self.chunks[sid] = st.chunks           # same list object
        self.fidelity_log[sid] = st.fidelity_log
        return True

    def ensure_resident(self, sid: int,
                        streams: Optional[Dict[int, Stream]] = None,
                        protect: Sequence[int] = ()) -> bool:
        assert sid in self.streams, f"stream {sid} was never admitted"
        return True                            # whole cache lives on-device

    def begin_chunk(self, sid: int, fidelity: FidelityConfig,
                    now: float) -> None:
        self.inflight[sid] = _Flight(fidelity=fidelity, started=now)

    def run_step(self, sids: Sequence[int]) -> Tuple[List[int], float]:
        assert len(sids) == 1, \
            "the sequential executor serves one stream per step"
        sid = sids[0]
        f = self.inflight.pop(sid)
        _, dt = self.generate_chunk(self.streams[sid], f.fidelity)
        f.active_s = dt
        return [sid], dt

    def remaining_estimate(self, sid: int) -> float:
        f = self.inflight.get(sid)
        if f is None:
            return 0.0
        return self.latency_ema.get(f.fidelity.key, 0.0)

    def abort_chunk(self, sid: int) -> None:
        """Drop the pending chunk (prompt switch before generation)."""
        self.inflight.pop(sid, None)

    def reset_condition(self, sid: int, seed: int) -> bool:
        """Prompt switch: re-encode a fresh conditioning and rebuild the
        stream's cache around it — the old prompt's context KV is
        discarded with it.  Unlike the batched executor, the noise
        sequence continues (the cache has no separate generation
        counter)."""
        self.inflight.pop(sid, None)
        st = self.streams[sid]
        st.cond = cond_noise(seed, self.cfg.d_model).to(self.device)
        st.cache = A.init_cache(self.cfg, self.params, st.cond)
        return True

    def retire(self, sid: int, drop_history: bool = False) -> None:
        """Retire a stream; ``drop_history=True`` also removes its
        record and generated chunks (warm-up calibration stream — no
        residue may survive into the serving session)."""
        self.inflight.pop(sid, None)
        if drop_history:
            self.streams.pop(sid, None)
            self.chunks.pop(sid, None)
            self.fidelity_log.pop(sid, None)


def serve_session(n_streams: int = 2, chunks_per_stream: int = 4,
                  realtime_budget: Optional[float] = None,
                  verbose: bool = True,
                  batched: bool = False,
                  max_batch: int = 4,
                  pool_streams: Optional[int] = None,
                  context_backend: str = "paged",
                  device: Any = "cuda") -> List[ServedStream]:
    """Legacy entry point — a thin wrapper over
    ``serve.session.StreamingSession`` (all streams arrive at t=0,
    exact per-stream chunk counts).

    ``realtime_budget``: seconds of playout per chunk; defaults to 4x
    the measured top-fidelity latency.  ``batched=True`` routes to the
    credit-ordered micro-batch executor (``serve.batcher``), where
    ``pool_streams`` caps co-resident streams and ``context_backend``
    picks ``"paged"`` or ``"gather"``."""
    if batched:
        from repro_torch.serve.batcher import serve_session_batched
        return serve_session_batched(
            n_streams=n_streams, chunks_per_stream=chunks_per_stream,
            max_batch=max_batch, realtime_budget=realtime_budget,
            pool_streams=pool_streams, context_backend=context_backend,
            verbose=verbose, device=device)
    from repro_torch.serve.session import (SessionConfig, StreamingSession,
                                           uniform_specs)
    session = StreamingSession(SessionConfig(
        executor="sequential", max_batch=1,
        realtime_budget=realtime_budget, verbose=verbose, device=device))
    for spec in uniform_specs(n_streams, chunks_per_stream):
        session.submit(spec)
    session.run()
    return session.served_streams()
