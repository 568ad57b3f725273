"""internvl2-26b [vlm] — InternViT + InternLM2 backbone.  [arXiv:2404.16821; hf]

Per the assignment, only the transformer BACKBONE is modeled; the InternViT
vision frontend is a STUB: ``input_specs()`` supplies precomputed patch
embeddings (n_frontend_tokens x d_model) that are prepended to the text
sequence.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=92553,
    frontend="patch",
    n_frontend_tokens=256,
))
