"""Set up the program's serving session for one cell and drive its window.

The entry the window drives is ``repro_torch.serve.session.StreamingSession
.run()`` over a ``BatchedChunkExecutor`` on the paged KV pool, built from
the benchmark's weights.  The benchmark's inputs reach the program through
the two functions the batched executor draws them from
(``batcher.cond_noise``, ``batcher.chunk_noise``), replaced for the run.

Arrivals start when set-up ends.  A ramp of ``ramp_s`` comes first, then
the measured window of ``seconds``; at its end the harness stops the
session from its own wrapper around ``ControlPlane.tick`` (the session has
no stop hook), without draining.  The wrappers around ``tick``,
``run_step`` and the session's idle wait are the harness's spans.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from streambench.lib import inputs
from streambench.lib.playout import StreamRecord, Window
from streambench.lib.traffic import CHUNK_SECONDS, Arrival

# (steps, sparsity, window, quant) of the warm-up's rounds: every batch size
# the session composes (1 to max_batch), dense and masked context, bf16 and
# fp8 pages, contexts of 0 to 3 chunks
WARMUP_ROUNDS = (
    [(4, 0.0, 7, "bf16")] * 4,
    [(4, 0.0, 7, "bf16"), (3, 0.6, 3, "bf16"), (2, 0.9, 1, "bf16"),
     (4, 0.0, 7, "bf16")],
    [(4, 0.0, 7, "fp8"), (2, 0.7, 3, "fp8"), (4, 0.0, 7, "bf16"),
     (3, 0.8, 7, "bf16")],
    [(4, 0.0, 7, "bf16"), (3, 0.0, 7, "bf16"), (2, 0.0, 3, "bf16"),
     (4, 0.6, 7, "fp8")],
)


# tokens of each chunk's first-layer K and V page read back after its write
PAGE_TOKENS = 256


class WindowClosed(Exception):
    """Raised inside the session's loop when the window's end is reached."""


@dataclasses.dataclass
class StepRecord:
    start: float                  # host perf_counter
    end: float
    keys: List[str]               # each row's fidelity
    chunk_idx: List[int]          # each row's chunks already in the pool
    denoise: List[bool]           # each row's phase
    launched: bool                # the step issued a batched launch


@dataclasses.dataclass
class RunRecord:
    streams: List[StreamRecord]
    window: Window
    t0: float                                   # session clock origin
    steps: List[StepRecord]
    tick_s: List[float]                         # the program's tick times
    spans: List[tuple]                          # (start, end, label)
    served: Dict[int, List[torch.Tensor]]       # chunks, playout order
    setup_s: float
    memory_peak: int
    pages: Dict[tuple, tuple] = dataclasses.field(default_factory=dict)
    trace: Optional[Dict] = None
    params: Any = None                          # the benchmark's weights
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)


def port_config(cfg: Dict):
    """The program's ``ModelConfig`` as the configuration file states it."""
    from repro_torch.configs.base import ModelConfig, get_config
    base = get_config(cfg["arch"])
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return dataclasses.replace(
        base, **{k: v for k, v in cfg.items() if k in fields and k != "name"})


def install_inputs(cfg: Dict, seed: int, device) -> None:
    """Hand the benchmark's conditioning and noise to the executor."""
    from repro_torch.serve import batcher

    def cond_noise(stream_seed: int, d_model: int) -> torch.Tensor:
        return inputs.cond(cfg, seed, stream_seed, device)

    def chunk_noise(chunk_seq: int, sid: int, tc: int) -> torch.Tensor:
        return inputs.noise(cfg, seed, sid, chunk_seq, device)

    batcher.cond_noise = cond_noise
    batcher.chunk_noise = chunk_noise


def warm_up(ex, max_batch: int) -> None:
    """Run every batch shape and path of the window once on scratch streams
    (sids below -1, reserved), then forget them and their timings."""
    from repro_torch.models.ardit import FidelityConfig
    sids = list(range(-2, -2 - max_batch, -1))
    for sid in sids:
        ex.admit(sid, seed=sid)
    for rnd in WARMUP_ROUNDS:
        groups: Dict[str, List[int]] = {}
        for sid, f in zip(sids, rnd):
            fid = FidelityConfig(*f)
            ex.begin_chunk(sid, fid, 0.0)
            groups.setdefault(fid.quant, []).append(sid)
        while ex.inflight:
            for grp in groups.values():
                live = [s for s in grp if s in ex.inflight]
                if live:
                    ex.run_step(live)
    for sid in sids:
        ex.retire(sid, drop_history=True)
    ex.latency_ema.clear()
    ex.step_ema.clear()
    if ex.device.type == "cuda":
        torch.cuda.synchronize(ex.device)


def run_window(cfg: Dict, arrivals: List[Arrival], *, seed: int,
               ramp_s: float, seconds: float, trace: bool, device,
               t_process: float,
               session_hook: Optional[Callable[[Any], None]] = None,
               ) -> RunRecord:
    """Set up, run the ramp and the window, stop, and collect the records.
    ``session_hook(session)`` may alter the session before the run (the
    control and the fault tests use it)."""
    from repro_torch.serve.batcher import BatchedChunkExecutor
    from repro_torch.serve.session import SessionConfig, StreamingSession
    from repro_torch.sched_sim.workloads import StreamSpec

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mcfg = port_config(cfg)
    params = inputs.make_weights(cfg, seed, dev)
    install_inputs(cfg, seed, dev)
    ex = BatchedChunkExecutor(mcfg, params=params,
                              max_streams=cfg["pool_streams"],
                              context_backend="paged", device=dev)
    warm_up(ex, cfg["max_batch"])
    session = StreamingSession(
        SessionConfig(executor="batched", context_backend="paged",
                      max_batch=cfg["max_batch"],
                      realtime_budget=CHUNK_SECONDS, verbose=False,
                      device=dev, model_cfg=mcfg),
        executor=ex)
    for a in arrivals:
        session.submit(StreamSpec(sid=a.sid, arrival=a.arrival,
                                  frames=a.frames, switches=a.switches,
                                  pauses=a.pauses))
    if session_hook is not None:
        session_hook(session)

    stop_at = ramp_s + seconds
    steps: List[StepRecord] = []
    spans: List[tuple] = []
    tracer = None
    if trace:
        from streambench.lib.trace import DeviceTrace
        tracer = DeviceTrace()
        tracer.prime()
    state = {"tick0": None, "tick1": None}

    tick = session.control.tick

    def timed_tick(view, now):
        if now >= ramp_s and state["tick0"] is None:
            state["tick0"] = len(session.control.tick_times)
            if tracer is not None:
                tracer.start()
        if now >= stop_at:
            state["tick1"] = len(session.control.tick_times)
            raise WindowClosed
        t = time.perf_counter()
        out = tick(view, now)
        spans.append((t, time.perf_counter(), "session.tick"))
        return out

    run_step = ex.run_step

    def timed_step(sids, sp_serve=False):
        flights = [ex.inflight[s] for s in sids]
        keys = [f.fidelity.key for f in flights]
        idx = [int(ex.pool.chunks[s]) for s in sids]
        dn = [f.step < f.fidelity.steps for f in flights]
        before = ex.dispatch_count
        t = time.perf_counter()
        out = run_step(sids, sp_serve=sp_serve)
        t1 = time.perf_counter()
        spans.append((t, t1, "executor.run_step"))
        steps.append(StepRecord(t, t1, keys, idx, dn,
                                ex.dispatch_count > before))
        return out

    append = ex.pool.append
    pages: Dict[tuple, tuple] = {}

    def read_back(sids, new_kv, quant):
        """The pool's write, then the first layer's page of each chunk
        written, as later chunks will read it."""
        append(sids, new_kv, quant)
        w = ex.pool.ledger.pages_per_stream - 1
        n_tok = min(PAGE_TOKENS, cfg["ardit_chunk_frames"]
                    * cfg["ardit_frame_tokens"])
        for sid in sids:
            n = ex.pool.chunks[sid] - 1
            page = int(ex.pool.ledger.tables[sid][1 + n % w])
            pages[(sid, len(ex.chunks[sid]))] = (
                ex.pool.k[0, page, :n_tok].clone(),
                ex.pool.v[0, page, :n_tok].clone())

    wait_for = session._wait_for

    def timed_wait(t_event):
        t = time.perf_counter()
        wait_for(t_event)
        spans.append((t, time.perf_counter(), "session.wait_for_arrival"))

    session.control.tick = timed_tick
    ex.run_step = timed_step
    session._wait_for = timed_wait
    ex.pool.append = read_back

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_process
    try:
        session.run()
        raise RuntimeError("the session ran out of work before the window "
                           "closed: the traffic offers too few arrivals")
    except WindowClosed:
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_stop = session._now()
    if tracer is not None:
        tracer.stop()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    counters = {k: getattr(ex, k) for k in ("evictions", "restores",
                                            "deferrals", "page_evictions")}
    walls = [st.end - st.start for st in steps]
    counters["longest_step_s"] = max(walls, default=0.0)
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        counters["alloc_retries"] = stats.get("num_alloc_retries", 0)
        counters["reserved_peak"] = stats.get(
            "reserved_bytes.all.peak", 0)

    # every stream scheduled before the stop counts: one the session has
    # not admitted is waiting (no chunk ready) or was refused at its front
    # door
    fd = session.front_door
    refused = {sid for sid, o in (fd.outcomes.items() if fd else ())
               if o == "rejected"}
    streams = []
    served: Dict[int, List[torch.Tensor]] = {}
    for a in arrivals:
        if a.arrival >= stop_at:
            break
        rec = session.view.streams.get(a.sid)
        ready = list(rec.ready_times) if rec is not None else []
        keys = list(ex.fidelity_log.get(a.sid, []))
        streams.append(StreamRecord(a.sid, a.arrival, a.chunks, ready, keys,
                                    refused=a.sid in refused))
        served[a.sid] = [c.detach().reshape(c.shape[-2], c.shape[-1])
                         for c in ex.chunks.get(a.sid, [])]
    record = RunRecord(
        streams=streams, window=Window(ramp_s, stop_at, t_stop),
        t0=session._t0, steps=steps,
        tick_s=list(session.control.tick_times[state["tick0"]:
                                               state["tick1"]]),
        spans=spans, served=served, pages=pages, setup_s=setup_s,
        memory_peak=memory_peak, counters=counters)
    if tracer is not None:
        record.trace = tracer.reduce(spans)
        tracer.prof = None
    # free the program's state (pool, weights' users) before the check
    del session, ex, tick, run_step, wait_for, append
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    record.params = params
    return record
