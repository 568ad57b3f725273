"""The port's plain chunk-query paged attention
(``repro_torch.kernels.paged_attention``) against the JAX reference's
two forms: its jnp oracle ``paged_chunk_attention_ref`` and the Pallas
kernel ``paged_chunk_attention_pallas`` in interpret mode.

Same numpy-seeded inputs on both sides; the case matrix is the
reference's ``TestPagedChunkAttention`` plus the paged-backend sweep,
and it covers the all-visible path, the compact extent, hole rows,
fully-masked rows, GQA and fp8 pages.  Tolerance: the partials m, l and
acc agree to 1e-5 (fp32, summation order only) with the oracle and to
2e-5 with the interpret-mode kernel (page-by-page online softmax, the
reference's own kernel-vs-oracle tolerance).  On CPU tensors the
wrapper runs this plain version; the CUDA kernel is held against it on
the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.kernels.paged_attention.kernel import paged_chunk_attention_pallas
from repro.kernels.paged_attention.ref import \
    paged_chunk_attention_ref as jax_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import NEG_INF, \
    paged_chunk_attention_ref

torch.set_num_threads(2)

TOL_REF = dict(rtol=1e-5, atol=1e-5)
TOL_KERNEL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, B, Sq, Hq, Hkv, D, page, n, p_total, density=0.6,
          kv_dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    kp = rng.normal(size=(p_total, page, Hkv, D)).astype(kv_dtype)
    vp = rng.normal(size=(p_total, page, Hkv, D)).astype(kv_dtype)
    bt = rng.integers(0, p_total, size=(B, n)).astype(np.int32)
    mask = rng.random((B, n * page)) < density
    return q, kp, vp, bt, mask


def _port(q, kp, vp, bt, mask, **hint):
    def t(a):
        if a.dtype == ml_dtypes.float8_e4m3fn:
            return torch.from_numpy(a.view(np.uint8).copy()).view(
                torch.float8_e4m3fn)
        return torch.from_numpy(np.ascontiguousarray(a))
    out = ops.paged_chunk_attention(
        t(q), t(kp), t(vp), t(bt), None if mask is None else t(mask),
        **hint)
    return [o.numpy() for o in out]


def _jax(fn, q, kp, vp, bt, mask, **kw):
    return [np.asarray(o) for o in fn(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        None if mask is None else jnp.asarray(mask), **kw)]


def _close(got, want, tol):
    for g, w, name in zip(got, want, ("m", "l", "acc")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


# the reference's TestPagedChunkAttention matrix and paged-backend sweep
MATRIX = [
    (2, 4, 4, 2, 16, 8, 4, 16),
    (3, 6, 8, 2, 8, 16, 3, 12),
    (1, 5, 4, 1, 64, 8, 6, 8),
    (1, 4, 2, 2, 16, 5, 2, 5),       # MHA, tiny pages
    (3, 8, 8, 2, 8, 6, 4, 12),       # GQA group of 4
    (2, 5, 6, 3, 4, 9, 1, 4),        # single-page table
]


@pytest.mark.parametrize("B,Sq,Hq,Hkv,D,page,n,ptot", MATRIX)
def test_explicit_mask_matches_jax_ref_and_kernel(B, Sq, Hq, Hkv, D, page,
                                                  n, ptot):
    q, kp, vp, bt, mask = _case(B * 100 + n, B, Sq, Hq, Hkv, D, page, n,
                                ptot)
    mask[0, :page] = False                       # a fully-masked page
    got = _port(q, kp, vp, bt, mask)
    _close(got, _jax(jax_ref, q, kp, vp, bt, mask), TOL_REF)
    _close(got, _jax(paged_chunk_attention_pallas, q, kp, vp, bt, mask,
                     interpret=True), TOL_KERNEL)


def test_all_visible_path_matches_jax():
    """page_mask=None with the layout hint: the valid prefix of every
    page (sink on entry 0, chunk_tokens on the others) is visible."""
    B, Sq, Hq, Hkv, D, page, n = 2, 6, 4, 2, 8, 7, 3
    q, kp, vp, bt, _ = _case(9, B, Sq, Hq, Hkv, D, page, n, 9)
    sink, tc = page - 1, page - 3
    got = _port(q, kp, vp, bt, None, sink=sink, chunk_tokens=tc)
    _close(got, _jax(jax_ref, q, kp, vp, bt, None, sink=sink,
                     chunk_tokens=tc), TOL_REF)
    _close(got, _jax(paged_chunk_attention_pallas, q, kp, vp, bt, None,
                     sink=sink, chunk_tokens=tc, interpret=True),
           TOL_KERNEL)
    # and equals the explicit prefix mask over full pages
    m = np.zeros((B, n, page), bool)
    m[:, 0, :sink] = True
    m[:, 1:, :tc] = True
    _close(got, _port(q, kp, vp, bt, m.reshape(B, -1)), TOL_REF)


def test_compact_extent_hole_rows_and_fully_masked_rows():
    """The serving layout: sink/chunk_tokens hints with an explicit mask
    (compact extent: dead page tails are never read), a hole row (a
    dropped ring page remapped to the stream's sink page, mask slice
    all false) and a batch row that sees nothing at all (m = NEG_INF,
    l = 0, acc = 0)."""
    B, Sq, Hq, Hkv, D, page, n = 3, 5, 4, 2, 16, 9, 4
    sink, tc = 7, 6
    q, kp, vp, bt, mask = _case(3, B, Sq, Hq, Hkv, D, page, n, 12)
    m = mask.reshape(B, n, page)
    m[:, 0, sink:] = False                       # dead sink-page tail
    m[:, 1:, tc:] = False                        # dead ring-page tails
    bt[1, 2] = bt[1, 0]                          # hole -> own sink page
    m[1, 2] = False
    m[2] = False                                 # row 2 sees nothing
    mask = m.reshape(B, -1)
    got = _port(q, kp, vp, bt, mask, sink=sink, chunk_tokens=tc)
    _close(got, _jax(jax_ref, q, kp, vp, bt, mask, sink=sink,
                     chunk_tokens=tc), TOL_REF)
    _close(got, _jax(paged_chunk_attention_pallas, q, kp, vp, bt, mask,
                     interpret=True), TOL_KERNEL)
    assert (got[0][2] == NEG_INF).all()
    assert (got[1][2] == 0).all() and (got[2][2] == 0).all()
    # the hint changes nothing when the tails are dead
    _close(got, _port(q, kp, vp, bt, mask), TOL_REF)


@pytest.mark.parametrize("masked", [False, True])
def test_fp8_pages_match_jax(masked):
    """float8_e4m3fn pages (fidelity knob Q): both sides read the same
    fp8 bits and widen to fp32."""
    B, Sq, Hq, Hkv, D, page, n = 2, 4, 4, 2, 16, 8, 3
    q, kp, vp, bt, mask = _case(21, B, Sq, Hq, Hkv, D, page, n, 8,
                                kv_dtype=ml_dtypes.float8_e4m3fn)
    hint = {} if masked else dict(sink=page, chunk_tokens=page - 2)
    mask = mask if masked else None
    got = _port(q, kp, vp, bt, mask, **hint)
    _close(got, _jax(jax_ref, q, kp, vp, bt, mask, **hint), TOL_REF)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    q, kp, vp, bt, mask = _case(0, 1, 2, 2, 1, 16, 4, 2, 3)
    before = ops.paged_chunk_attention.launches
    want = paged_chunk_attention_ref(*(torch.from_numpy(a) for a in
                                       (q, kp, vp, bt, mask)))
    got = _port(q, kp, vp, bt, mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert ops.paged_chunk_attention.launches == before   # no kernel


def test_wrapper_rejects_other_devices():
    q = torch.zeros((1, 2, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_chunk_attention(q, q, q, q, None, sink=1, chunk_tokens=1)
