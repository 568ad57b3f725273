"""Sharding-aware synthetic data pipeline (a copy of the JAX reference's
``data/pipeline.py``, imports rewritten; it returns numpy, and the train
step moves a batch onto its device).

Deterministic per (seed, step, shard): every data-parallel host generates
exactly its own slice of the global batch with no coordination, and the
SAME global batch is produced for any DP layout — so elastic rescale or
restart-from-checkpoint replays identical data (bitwise), which is what
makes the fault-tolerance story testable.  Token streams are Zipf-ish
synthetic text; AR-DiT batches are unit-Gaussian latents + cond stubs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2


def _rng_for(seed: int, step: int, row: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, row]))


def _tokens_row(cfg: ModelConfig, dcfg: DataConfig, step: int, row: int,
                seq_len: int) -> np.ndarray:
    rng = _rng_for(dcfg.seed, step, row)
    v = max(cfg.vocab_size, 4)
    toks = rng.zipf(dcfg.zipf_a, size=seq_len + 1).astype(np.int64)
    return np.clip(toks, 1, v - 1).astype(np.int32)


def global_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, *,
                 dcfg: DataConfig = DataConfig(),
                 rows: Optional[range] = None) -> Dict[str, Any]:
    """Build (a slice of) the global train batch for ``step``.

    ``rows``: which global-batch rows to materialize (a DP shard asks for
    its own range); defaults to all rows.
    """
    rows = rows if rows is not None else range(shape.global_batch)
    if cfg.family == "ardit":
        from repro_torch.models import ardit as A
        tc = A.chunk_tokens(cfg)
        n_chunks = max(1, shape.seq_len // tc)
        rng = _rng_for(dcfg.seed, step, 10**6)
        b = len(rows)
        return {
            "latents": rng.standard_normal(
                (b, n_chunks, tc, A.LATENT_CH)).astype(np.float32),
            "cond": rng.standard_normal(
                (b, A.COND_TOKENS, cfg.d_model)).astype(np.float32),
            "t": rng.uniform(0.05, 0.95, (b, n_chunks)).astype(np.float32),
            "noise": rng.standard_normal(
                (b, n_chunks, tc, A.LATENT_CH)).astype(np.float32),
        }
    s_text = shape.seq_len
    if cfg.family == "vlm":
        s_text = shape.seq_len - cfg.n_frontend_tokens
    toks = np.stack([_tokens_row(cfg, dcfg, step, r, s_text) for r in rows])
    batch: Dict[str, Any] = {"tokens": toks[:, :-1],
                             "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        rng = _rng_for(dcfg.seed, step, 10**6 + 1)
        batch["img_embeds"] = rng.standard_normal(
            (len(rows), cfg.n_frontend_tokens, cfg.d_model)).astype(
                np.float32) * 0.02
    if cfg.family == "encdec":
        rng = _rng_for(dcfg.seed, step, 10**6 + 2)
        batch["audio_embeds"] = rng.standard_normal(
            (len(rows), cfg.n_frontend_tokens, cfg.d_model)).astype(
                np.float32) * 0.02
    return batch


def shard_rows(global_batch_size: int, dp_rank: int,
               dp_size: int) -> range:
    per = global_batch_size // dp_size
    return range(dp_rank * per, (dp_rank + 1) * per)


def batches(cfg: ModelConfig, shape: ShapeConfig, *,
            start_step: int = 0, dcfg: DataConfig = DataConfig(),
            dp_rank: int = 0, dp_size: int = 1) -> Iterator[Dict[str, Any]]:
    step = start_step
    while True:
        rows = shard_rows(shape.global_batch, dp_rank, dp_size)
        yield global_batch(cfg, shape, step, dcfg=dcfg, rows=rows)
        step += 1
