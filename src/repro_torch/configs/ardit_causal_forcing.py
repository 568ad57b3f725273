"""AR-DiT (Causal-Forcing).  [arXiv:2602.02214]

Same Wan-1.3B backbone family as Self-Forcing with a deeper head count;
the two AR-DiT configs let the end-to-end benchmarks reproduce both model
columns of the paper's Figure 11.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="ardit-causal-forcing",
    family="ardit",
    n_layers=30,
    d_model=1536,
    n_heads=16,
    n_kv_heads=16,
    d_head=96,
    d_ff=8960,
    vocab_size=0,
    act="gelu",
    ardit_frame_tokens=880,
    ardit_chunk_frames=3,
    ardit_sink_chunks=1,
    ardit_window_chunks=7,
    denoise_steps=4,
))
