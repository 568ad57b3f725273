"""minitron-8b [dense] — pruned nemotron.  [arXiv:2407.14679; hf]

Registered for its attention geometry (32 query heads over 8 KV heads of
128, bf16): ``chip_smoke.py`` drives the paged decode kernel and the fp8
matmul at its decode_32k / prefill_32k shapes.  The dense family's model
code waits for its slice (``models.registry.get_api`` raises).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=256000,
))
