"""Everything a run feeds the program, made from ``--seed`` on the card.

The weights come in the layout the AR-DiT serving path takes (stacked
``[L, ...]`` layer tensors), drawn with a ``torch.Generator`` on the device
in one call a tensor and in the served type, the adaLN gates open so that
every layer's attention and MLP reach the output.  Each stream's
conditioning and each chunk's initial noise are drawn from a generator
seeded by (run seed, stream, chunk): the same seed gives the same inputs,
and the reference asks for them again by the same call.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sub_seed(seed: int, *parts: int) -> int:
    """A 63-bit generator seed from the run seed and the given parts."""
    h = hashlib.sha256(repr((int(seed),) + tuple(int(p) for p in parts))
                       .encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """Random weights of one AR-DiT configuration on ``device``: dense
    layers N(0, 1/fan_in) (the output projection N(0, 0.02^2)), the
    modulation weights N(0, 0.2^2), their bias 0.5 + N(0, 0.2^2), the final
    norm ones."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    dt = DTYPES[cfg["param_dtype"]]
    d, n_l = cfg["d_model"], cfg["n_layers"]
    hq, hkv, dh, ff = (cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"],
                       cfg["d_ff"])
    c = cfg["latent_channels"]

    def randn(shape, scale, shift=0.0):
        t = torch.randn(shape, generator=g, device=device, dtype=dt)
        t.mul_(scale)
        if shift:
            t.add_(shift)
        return t

    def dense(shape, scale=None):
        return randn(shape, scale or 1.0 / math.sqrt(shape[-2]))

    return {
        "in_proj": dense((c, d)),
        "cond_proj": dense((d, d)),
        "t_mlp1": dense((256, d)),
        "t_mlp2": dense((d, d)),
        "layers": {
            "attn": {"wq": dense((n_l, d, hq * dh)),
                     "wk": dense((n_l, d, hkv * dh)),
                     "wv": dense((n_l, d, hkv * dh)),
                     "wo": dense((n_l, hq * dh, d))},
            "mlp": {"wi": dense((n_l, d, ff)), "wo": dense((n_l, ff, d))},
            "mod": randn((n_l, d, 6 * d), 0.2),
            "mod_b": randn((n_l, 6 * d), 0.2, 0.5),
        },
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "final_mod": randn((d, 2 * d), 0.2),
        "out_proj": dense((d, c), 0.02),
    }


def cond(cfg: Dict, seed: int, sid: int, device) -> torch.Tensor:
    """A stream's conditioning [1, cond_tokens, d_model], N(0, 0.02^2)."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1, sid))
    return torch.randn((1, cfg["cond_tokens"], cfg["d_model"]), generator=g,
                       device=device) * 0.02


def noise(cfg: Dict, seed: int, sid: int, chunk: int,
          device) -> torch.Tensor:
    """A chunk's initial latents [1, chunk_tokens, latent_channels]."""
    g = torch.Generator(device=device).manual_seed(
        sub_seed(seed, 2, sid, chunk))
    tc = cfg["ardit_chunk_frames"] * cfg["ardit_frame_tokens"]
    return torch.randn((1, tc, cfg["latent_channels"]), generator=g,
                       device=device)
