"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

Layer l is an attention layer iff (l % attn_every) == attn_every // 2
(1 attention : 7 Mamba).  MoE FFN on every other layer (moe_every=2).
Attention layers keep a bounded sink+window KV cache so long_500k decode is
sub-quadratic (Mamba state carries long-range context).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_every=2,
    attn_every=8,           # 1 attention layer per 8 (1:7 interleave)
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_window=8192,       # bounded attention cache for long-context decode
    attn_sink=128,
))
