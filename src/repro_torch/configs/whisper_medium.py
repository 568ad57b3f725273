"""whisper-medium [audio] — enc-dec, conv frontend (stub).  [arXiv:2212.04356]

Per the assignment the conv/mel frontend is a STUB: ``input_specs()``
provides precomputed frame embeddings (batch, seq, d_model) to the encoder.
24 encoder + 24 decoder layers.  Decode shapes exercise the DECODER
(self-attn KV cache of seq_len + cross-attn over encoder states).

Served through ``models.registry.get_api`` by ``models/encdec.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    n_enc_layers=24,
    n_dec_layers=24,
    frontend="audio",
    n_frontend_tokens=1500,
))
