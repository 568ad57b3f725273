"""granite-moe-1b-a400m [moe] — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,               # dense-equivalent listing; MoE experts below
    vocab_size=49155,
    n_experts=32,
    top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
))
