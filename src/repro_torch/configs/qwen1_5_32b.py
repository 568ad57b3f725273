"""qwen1.5-32b [dense] — QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,          # GQA kv=40 (full MHA-width KV)
    d_head=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
))
