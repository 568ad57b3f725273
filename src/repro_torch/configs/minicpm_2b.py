"""minicpm-2b [dense] — WSD schedule (arch=llama-like).  [arXiv:2404.06395; hf]

The WSD (warmup-stable-decay) schedule this model was trained with is
implemented in ``repro_torch/train/optimizer.py`` and selected by this
config.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_head=64,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
))
