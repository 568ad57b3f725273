"""The port's paged KV cache helpers (``repro_torch.models.kvcache``)
against the JAX reference: page geometry, ring slots, the table-order
visibility mask, the in-place page write, and the fp8 cast helper that
reproduces JAX's ``astype(float8_e4m3fn)`` overflow (NaN above 464
where torch alone saturates to 448).  All comparisons are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
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
