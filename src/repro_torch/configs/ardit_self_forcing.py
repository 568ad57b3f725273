"""AR-DiT (Self-Forcing): the paper's own model family.  [arXiv Self-Forcing]

Wan2.1-T2V-1.3B-derived causal video DiT: 30 layers, d=1536, 12 heads,
ff 8960.  480p latents -> 3 latent frames per chunk, 880 tokens per latent
frame (60x44 patch grid / 4x temporal VAE), sink+local rolling KV.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="ardit-self-forcing",
    family="ardit",
    n_layers=30,
    d_model=1536,
    n_heads=12,
    n_kv_heads=12,
    d_head=128,
    d_ff=8960,
    vocab_size=0,           # latent-space model: no token embedding
    act="gelu",
    ardit_frame_tokens=880,
    ardit_chunk_frames=3,
    ardit_sink_chunks=1,
    ardit_window_chunks=7,
    denoise_steps=4,
))
