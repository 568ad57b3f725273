"""The port's paged KV cache helpers (``repro_torch.models.kvcache``)
against the JAX reference: page geometry, ring slots, the table-order
visibility mask, the in-place page write, and the fp8 cast helper that
reproduces JAX's ``astype(float8_e4m3fn)`` overflow (NaN above 464
where torch alone saturates to 448).  All comparisons are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.models import kvcache as JK
from repro_torch.models import kvcache as TK

torch.set_num_threads(2)


def test_page_geometry_and_ring_slots():
    for w in (1, 2, 7):
        assert TK.pages_per_stream(w) == JK.pages_per_stream(w)
        for c in range(3 * w + 2):
            assert TK.page_of_chunk(c, w) == JK.page_of_chunk(c, w)
            assert TK.chunk_slot(c, w, 77, 48) == \
                int(JK.chunk_slot(jnp.asarray(c), w, 77, 48))
    idx = np.arange(9)
    np.testing.assert_array_equal(
        TK.chunk_slot(torch.from_numpy(idx), 3, 7, 5).numpy(),
        np.asarray(JK.chunk_slot(jnp.asarray(idx), 3, 7, 5)))


@pytest.mark.parametrize("n_ring", [0, 1, 3])
def test_mask_to_pages_matches_reference(n_ring):
    rng = np.random.default_rng(n_ring)
    sink, tc, page = 5, 3, 7
    mask = rng.random((3, sink + max(n_ring, 1) * tc + 2)) < 0.5
    np.testing.assert_array_equal(
        TK.mask_to_pages(mask, n_ring, sink, tc, page),
        JK.mask_to_pages(mask, n_ring, sink, tc, page))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_pool_write_pages_in_place(dtype):
    rng = np.random.default_rng(7)
    pool = rng.normal(size=(2, 6, 5, 2, 4)).astype(np.float32)
    new = rng.normal(size=(2, 3, 4, 2, 4)).astype(np.float32)
    pages = np.asarray([4, 0, 2], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = JK.pool_write_pages(jnp.asarray(pool, jdt), jnp.asarray(new),
                               jnp.asarray(pages))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tp = torch.from_numpy(pool).to(tdt)
    ptr = tp.data_ptr()
    TK.pool_write_pages(tp, torch.from_numpy(new), pages.tolist())
    assert tp.data_ptr() == ptr                  # written in place
    np.testing.assert_array_equal(tp.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_fp8_cast_follows_jax_overflow():
    vals = np.asarray([0.0, 1.3, -2.75, 447.0, 449.0, 464.0, 464.1, 470.0,
                       1e4, -464.0, -464.1, -1e4, np.inf, -np.inf],
                      np.float32)
    want = np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn)
                      .astype(jnp.float32))
    got = TK.to_fp8_e4m3(torch.from_numpy(vals))
    assert got.dtype == torch.float8_e4m3fn
    got = got.float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_array_equal(got[fin], want[fin])
    assert np.isnan(got[vals == 464.1]).all() and got[vals == 464.0] == 448
    # torch's own cast saturates: the helper is what keeps parity
    assert torch.tensor([1e4]).to(torch.float8_e4m3fn).float().item() == 448


def test_fp8_cast_bf16_input_bitwise():
    rng = np.random.default_rng(11)
    x = (rng.normal(size=4096) * 120).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(xb.astype(jnp.float8_e4m3fn).astype(jnp.float32))
    got = TK.to_fp8_e4m3(torch.from_numpy(x).to(torch.bfloat16)).float()
    np.testing.assert_array_equal(got.numpy(), want)


# the overflow edge of e4m3 (448 is its largest finite value; JAX rounds
# up to 464 to 448 and gives NaN above), infinities and NaN
_EDGE = [447.0, 464.0, 464.1, 500.0, 1e4, np.inf, -np.inf, np.nan]


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [False, True], ids=["pages", "heads"])
def test_pool_write_into_fp8_pool_follows_jax(src, heads):
    """A block written into an e4m3 pool: NaN where the reference's
    ``astype`` gives NaN (torch's ``copy_`` would saturate to 448), the
    finite bytes equal bit for bit.  In bf16 464.1 rounds to 464."""
    rng = np.random.default_rng(23)
    pool = (rng.normal(size=(2, 5, 6, 4, 8)) * 100).astype(np.float32)
    hs, off = (2, 1) if heads else (4, 0)
    new = (rng.normal(size=(2, 3, 5, hs, 8)) * 300).astype(np.float32)
    new[0, :, 0, 0, :len(_EDGE)] = _EDGE
    new[1, :, 1, -1, :len(_EDGE)] = [-v for v in _EDGE]
    pages = np.asarray([3, 0, 4], np.int32)
    jdt = jnp.bfloat16 if src == "bfloat16" else jnp.float32
    jpool = jnp.asarray(pool).astype(jnp.float8_e4m3fn)
    jnew = jnp.asarray(new, jdt)
    if heads:
        want = JK.pool_write_pages_heads(jpool, jnew, jnp.asarray(pages),
                                         off)
    else:
        want = JK.pool_write_pages(jpool, jnew, jnp.asarray(pages))
    want = np.asarray(want.astype(jnp.float32))
    tp = TK.to_fp8_e4m3(torch.from_numpy(pool))
    tnew = torch.from_numpy(new).to(getattr(torch, src))
    if heads:
        TK.pool_write_pages_heads(tp, tnew, pages.tolist(), off)
    else:
        TK.pool_write_pages(tp, tnew, pages.tolist())
    assert tp.dtype == torch.float8_e4m3fn
    got = tp.float().numpy()
    nan = np.isnan(want)
    assert nan[:, pages].any()                   # the edge values landed
    np.testing.assert_array_equal(np.isnan(got), nan)
    wb = np.asarray(jnp.asarray(want).astype(jnp.float8_e4m3fn)).view(
        np.uint8)
    np.testing.assert_array_equal(tp.view(torch.uint8).numpy()[~nan],
                                  wb[~nan])
    if src == "bfloat16":       # 464.1 is 464 in bf16: finite, 448
        assert got[0, 3, 0, off, 2] == 448.0
    else:
        assert np.isnan(got[0, 3, 0, off, 2])


# ---- the token caches' sink + ring helpers --------------------------------

@pytest.mark.parametrize("seq_len,window,sink", [
    (24, 0, 0), (24, 8, 4), (12, 8, 4), (5, 8, 4), (32800, 8192, 128),
    (100, 16, 0)])
def test_ring_capacity_slots_and_valid_counts(seq_len, window, sink):
    """``capacity``, ``ring_dest`` and ``n_valid`` over every position up
    to well past the ring, int32 slots, bit for bit."""
    cap = TK.capacity(seq_len, window, sink)
    assert cap == JK.capacity(seq_len, window, sink)
    pos = np.arange(0, 3 * cap + 5, dtype=np.int32)
    got = TK.ring_dest(torch.from_numpy(pos), cap, sink)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JK.ring_dest(jnp.asarray(pos), cap, sink)))
    np.testing.assert_array_equal(
        TK.n_valid(torch.from_numpy(pos), cap).numpy(),
        np.asarray(JK.n_valid(jnp.asarray(pos), cap)))


@pytest.mark.parametrize("dest", [[0, 5, 11], [11, 11, 3], [12, 40, 7]],
                         ids=["inside", "last", "past-the-end"])
def test_write_token_matches_reference(dest):
    """One token per row at a per-row slot, in place; a slot past the end
    writes the last one, as the reference's ``dynamic_update_slice``
    clamps its start."""
    rng = np.random.default_rng(len(dest))
    cache = rng.normal(size=(3, 12, 2, 4)).astype(np.float32)
    new = rng.normal(size=(3, 1, 2, 4)).astype(np.float32)
    d = np.asarray(dest, np.int32)
    t = torch.from_numpy(cache.copy())
    out = TK.write_token(t, torch.from_numpy(new), torch.from_numpy(d))
    assert out.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(JK.write_token(jnp.asarray(cache),
                                               jnp.asarray(new),
                                               jnp.asarray(d))))


@pytest.mark.parametrize("s,cap,sink,window", [
    (10, 24, 4, 8), (10, 10, 0, 0), (20, 12, 4, 8), (37, 12, 4, 8),
    (100, 16, 0, 16), (33, 13, 5, 8)])
def test_place_prefill_matches_reference(s, cap, sink, window):
    """A prefill's K/V [B,S,H,D] placed into the cache: padded when it
    fits, else the sink and the last token of each ring slot gathered."""
    k = np.random.default_rng(s).normal(size=(2, s, 2, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        TK.place_prefill(torch.from_numpy(k), cap, sink, window).numpy(),
        np.asarray(JK.place_prefill(jnp.asarray(k), cap, sink, window)))
