"""Operation and byte counts against hand arithmetic at small shapes."""
import pytest

from streambench.lib import flops

CFG = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 2,
       "d_head": 4, "d_ff": 16, "latent_channels": 3, "cond_tokens": 5,
       "ardit_chunk_frames": 1, "ardit_frame_tokens": 128,
       "ardit_window_chunks": 3, "kv_dtype": "bfloat16"}


def test_visible_context():
    # chunk 2 (two chunks of context), window 7 -> sink + 2 chunks
    assert flops.visible_context(CFG, "S4_r0.0_W7_bf16", 2, True) == 261
    # window 1 keeps the newest chunk only
    assert flops.visible_context(CFG, "S4_r0.0_W1_bf16", 5, True) == 133
    # the first chunk sees the sink alone
    assert flops.visible_context(CFG, "S4_r0.9_W7_bf16", 0, True) == 5
    # rho 0.9 over 3 chunks of 128: the first and last block kept, of the
    # one middle block round(0.1) = 0; the clean pass sees all of it
    assert flops.visible_context(CFG, "S4_r0.9_W7_bf16", 3, True) == 261
    assert flops.visible_context(CFG, "S4_r0.9_W7_bf16", 3, False) == 389


def test_row_forward_flops():
    per_tok = 2 * (8 * 8 + 2 * 8 * 8 + 8 * 8 + 2 * 8 * 16) + 2 * 8 * 3
    want = 2.0 * per_tok * 128 + 2 * 4.0 * 128 * (261 + 128) * 2 * 4
    assert flops.row_forward_flops(CFG, 261) == want


def test_paged_call_and_bound():
    ops, nbytes = flops.paged_call(CFG, [5, 261])
    assert ops == 4.0 * 128 * 2 * 4 * (5 + 261)
    per_row = 2 * 128 * 2 * 4 + 4 * 4 + 4 * 2 * 128 * (4 + 2)
    assert nbytes == 2 * per_row + 2 * 2 * 4 * 2 * (5 + 261)
    assert flops.bound_seconds(ops, nbytes) == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12))
