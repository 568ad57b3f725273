"""Traced-step analysis: FLOPs/bytes, collective traffic and the
three-term roofline, a port of the JAX reference's
``launch/analysis.py``.

    compute    = FLOPs / (chips x peak FLOP/s)
    memory     = bytes / (chips x HBM bandwidth)
    collective = collective_bytes / (chips x link bandwidth)

Hardware constants: the NVIDIA H100 SXM5 80GB datasheet values in place
of the reference's TPU v5e constants — 989e12 FLOP/s dense bf16 per
card, 3.35e12 B/s HBM3, 450e9 B/s NVLink per direction per card.  The
per-device numbers come from ``launch/hlo_cost.py`` (a dispatch trace
on fake tensors, ``launch/lowering.py``); its bytes are an unfused
upper bound, so the memory term is too.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: float                  # total FLOPs (all devices)
    hbm_bytes: float              # total bytes accessed
    coll_bytes: float             # total collective bytes
    coll_by_op: Dict[str, int]
    n_chips: int
    per_device_bytes: Optional[float]   # argument+output bytes per device

    @property
    def t_compute(self) -> float:
        return self.flops / (self.n_chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.n_chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.n_chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline-optimistic step time: max of the three terms
        (perfect overlap assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def row(self) -> Dict[str, float]:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "per_device_bytes": self.per_device_bytes,
        }


def analyze(lowered, n_chips: int) -> Roofline:
    """Roofline terms of a traced step (``lowering.Lowered``, whose
    numbers are PER-DEVICE, so totals are x n_chips)."""
    return Roofline(flops=lowered.flops * n_chips,
                    hbm_bytes=lowered.hbm_bytes * n_chips,
                    coll_bytes=lowered.coll_bytes * n_chips,
                    coll_by_op={k: int(v * n_chips)
                                for k, v in lowered.coll_by_op.items()},
                    n_chips=n_chips,
                    per_device_bytes=float(lowered.argument_bytes
                                           + lowered.output_bytes))


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D (MoE) for train;
    2*N*D for prefill; 2*N per token x batch for decode."""
    n_active = active_params(cfg)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # one new token each


def active_params(cfg) -> float:
    """Analytic active-parameter count (MoE: top_k experts only)."""
    d, f, L, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    if cfg.family == "ssm":
        di = cfg.ssm_expand * d
        n = cfg.ssm_state
        per = d * (2 * di + 2 * n + di // cfg.ssm_head_dim) + di * d
        return L * per + v * d
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = d * (hq * dh) + 2 * d * (hkv * dh) + (hq * dh) * d
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import sublayer_kinds
        kinds = sublayer_kinds(cfg)
        di = cfg.ssm_expand * d
        n = cfg.ssm_state
        mamba = d * (2 * di + 2 * n + di // cfg.ssm_head_dim) + di * d
        total = 0.0
        for mixer, ffn in kinds:
            total += attn if mixer == "attn" else mamba
            if ffn == "moe":
                total += cfg.top_k * 3 * d * cfg.moe_d_ff
            else:
                total += 3 * d * f
        return total * (L / len(kinds)) + 2 * v * d
    if cfg.n_experts:
        ffn = cfg.top_k * 3 * d * cfg.moe_d_ff + d * cfg.n_experts
    elif cfg.act == "swiglu":
        ffn = 3 * d * f
    else:
        ffn = 2 * d * f
    n_layers = L
    if cfg.family == "encdec":
        n_layers = cfg.n_enc_layers + cfg.n_dec_layers
        attn = attn * 1.5            # decoder adds cross-attention
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    return n_layers * (attn + ffn) + emb
