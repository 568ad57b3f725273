"""Model / shape configuration system.

Every assigned architecture is a frozen ``ModelConfig``; the registry maps
``--arch <id>`` to its config.  ``reduced()`` derives a tiny same-family
config for CPU smoke tests.  Shapes are the four assigned input-shape cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes (assigned: every arch is paired with these four cells)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str               # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str             # dense | moe | vlm | hybrid | ssm | encdec | ardit
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    act: str = "swiglu"             # swiglu | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden size
    moe_every: int = 1              # MoE FFN applied every k-th layer
    capacity_factor: float = 1.25
    # --- hybrid / ssm (Mamba-2) ---
    attn_every: int = 0             # hybrid: 1 attention layer per `attn_every`
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128            # SSD chunk length
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- multimodal frontend stub ---
    frontend: str = "none"          # none | patch | audio
    n_frontend_tokens: int = 0      # tokens contributed by the stub frontend
    # --- AR-DiT (the paper's model family) ---
    ardit_frame_tokens: int = 0     # tokens per latent frame (h/p * w/p)
    ardit_chunk_frames: int = 3     # latent frames per chunk (paper default)
    ardit_sink_chunks: int = 1      # attention-sink chunks kept forever
    ardit_window_chunks: int = 7    # local KV window (fidelity knob W max)
    denoise_steps: int = 4          # fidelity knob S default (highest quality)
    # --- serving ---
    attn_window: int = 0            # >0: sliding-window attention (tokens)
    attn_sink: int = 0              # sink tokens kept with windowed attention
    # --- numerics ---
    param_dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"      # fidelity knob Q can lower this to fp8
    # beyond-paper perf lever (EXPERIMENTS.md SSPerf): round backward
    # cotangents to bf16 at layer boundaries (halves backward-activation
    # collectives + HBM traffic; fp32 optimizer math unaffected)
    bf16_backward: bool = False
    # beyond-paper perf lever: expert parallelism — shard the EXPERT dim
    # over "model" (all-to-all dispatch) instead of expert-TP (hidden dim
    # over "model"); wins when per-expert hidden is small (granite: 512)
    moe_ep: bool = False
    # beyond-paper perf lever: parallel layout for training.
    #   "tp_fsdp" (default): TP over "model", FSDP over "data"
    #   "zero3": batch + params sharded over BOTH axes (256-way ZeRO-3,
    #            no tensor parallelism) — trades activation psums for
    #            per-layer parameter all-gathers
    parallel_layout: str = "tp_fsdp"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding to a multiple of 256 so the
        vocab-parallel embedding/head shard evenly on any TP degree up
        to 256.  Token ids stay < vocab_size; padded rows are ordinary
        learnable rows that are never targets."""
        return ((self.vocab_size + 255) // 256) * 256 if self.vocab_size \
            else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def supports_shape(self, shape: ShapeConfig) -> bool:
        """Whether the (arch x shape) cell is runnable per the assignment.

        long_500k needs sub-quadratic attention: run for SSM / hybrid archs;
        pure full-attention archs are skipped (a windowed-KV adaptation is
        lowered separately, see DESIGN.md SS4).
        """
        if shape.name == "long_500k":
            return self.family in ("ssm", "hybrid") or self.attn_window > 0
        return True

    def with_window(self, window: int, sink: int = 4096) -> "ModelConfig":
        """Paper-technique adaptation: sink+local KV (SS2.1) for long contexts."""
        return replace(self, attn_window=window, attn_sink=sink)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            d_head=16,
            d_ff=128,
            vocab_size=256,
            param_dtype="float32",
            kv_dtype="float32",
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=2, moe_d_ff=64)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.n_enc_layers:
            kw.update(n_enc_layers=2, n_dec_layers=2)
        if self.n_frontend_tokens:
            kw.update(n_frontend_tokens=8)
        if self.ardit_frame_tokens:
            kw.update(ardit_frame_tokens=16)
        if self.attn_every:
            kw.update(attn_every=min(self.attn_every, 4), n_layers=4)
        return replace(self, name=self.name + "-reduced", **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    # Import every per-arch module for its registration side effect.
    from repro_torch.configs import (  # noqa: F401
        qwen1_5_32b, minitron_8b, minicpm_2b, internlm2_20b,
        granite_moe_1b_a400m, qwen3_moe_235b_a22b, internvl2_26b,
        jamba_v0_1_52b, mamba2_780m, whisper_medium,
        ardit_self_forcing, ardit_causal_forcing,
    )
    _LOADED = True


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count: the registry's ``init`` on torch's
    ``meta`` device (shapes and dtypes only, nothing drawn or
    allocated), summed."""
    from repro_torch.models import registry as model_registry

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        else:
            yield tree

    params = model_registry.get_api(cfg).init(cfg, None, device="meta")
    return sum(t.numel() for t in leaves(params))
