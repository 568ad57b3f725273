"""mamba2-780m [ssm] — SSD (state-space duality).  [arXiv:2405.21060]

Attention-free; the paper's attention-specific fidelity knobs (rho, W) are
inapplicable (DESIGN.md SSArch-applicability) — the fidelity space for this
family degenerates to {Q, chunk size}.  Decode is O(1)/token, so long_500k
runs natively.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=0,                 # no MLP; Mamba-2 blocks only
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
))
