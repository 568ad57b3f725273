"""The port's paged decode attention against the JAX reference's, on the
CPU: ``ops.paged_decode_attention`` (the plain version on CPU tensors)
against ``paged_decode_attention_pallas(interpret=True)`` and the
reference's oracle, at the reference test's three shapes and length 1;
``models.attention.decode_attention`` (the oracle's inner function)
with a window and a sink; the length-0 behaviours; and the tensor-core
path's split over the sequence: its unit plan (``ops.decode_units``, the
grid the kernel launches) covers every visible token once, and per-unit
plain partials merged by the plain combine
(``ref.paged_decode_partials_ref`` / ``ref.combine_decode_partials``)
match the Pallas kernel within 1e-5.

Inputs come from a numpy generator and go to both frameworks.
Tolerances: 2e-3 against the Pallas kernel (the reference test's own
limit); 1e-5 against the oracle, which is the same fp32 gather, einsum
and softmax (the measured maximum is printed).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import \
    paged_decode_attention_pallas
from repro.kernels.paged_attention.ref import \
    paged_decode_attention_ref as jax_decode_ref
from repro.models.attention import decode_attention as jax_decode_attention
from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.models.attention import decode_attention

torch.set_num_threads(2)

TOL_PALLAS = dict(rtol=2e-3, atol=2e-3)
TOL_ORACLE = dict(rtol=1e-5, atol=1e-5)


def _case(B, Hq, Hkv, D, page, npg, ptot, seed, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D), dtype=np.float32)
    kp = rng.standard_normal((ptot, page, Hkv, D), dtype=np.float32)
    vp = rng.standard_normal((ptot, page, Hkv, D), dtype=np.float32)
    bt = rng.integers(0, ptot, (B, npg)).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(1, npg * page + 1, (B,))
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


def _port(q, kp, vp, bt, ln):
    return ops.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(ln)).numpy()


def _jax(fn, q, kp, vp, bt, ln, **kw):
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                         jnp.asarray(bt), jnp.asarray(ln), **kw))


CASES = [  # B, Hq, Hkv, D, page, npg, ptot, lengths
    (2, 4, 2, 16, 8, 4, 16, None),
    (3, 8, 8, 32, 16, 3, 12, None),
    (1, 4, 1, 64, 8, 6, 8, None),
    (2, 4, 2, 16, 8, 2, 4, (1, 1)),            # the length-one test
]


@pytest.mark.parametrize("case", CASES,
                         ids=["gqa2", "mha", "gqa4", "length1"])
def test_paged_decode_matches_jax(case):
    *shape, lengths = case
    q, kp, vp, bt, ln = _case(*shape, seed=sum(shape), lengths=lengths)
    before = ops.paged_decode_attention.launches
    got = _port(q, kp, vp, bt, ln)
    assert ops.paged_decode_attention.launches == before   # plain on CPU
    pallas = _jax(paged_decode_attention_pallas, q, kp, vp, bt, ln,
                  interpret=True)
    oracle = _jax(jax_decode_ref, q, kp, vp, bt, ln)
    assert got.shape == q.shape and got.dtype == np.float32
    print(f"max |port - pallas| {np.abs(got - pallas).max():.3g}, "
          f"|port - oracle| {np.abs(got - oracle).max():.3g}")
    np.testing.assert_allclose(got, pallas, **TOL_PALLAS)
    np.testing.assert_allclose(got, oracle, **TOL_ORACLE)


def test_pages_past_the_length_are_not_read():
    """Table entries of pages wholly past a stream's length may point
    anywhere: the output does not change when they do."""
    q, kp, vp, bt, _ = _case(2, 4, 2, 16, 8, 4, 16, seed=5)
    ln = np.asarray([9, 3], np.int32)       # pages 2-3 / 1-3 unused
    base = _port(q, kp, vp, bt, ln)
    bt2 = bt.copy()
    bt2[0, 2:] = 15 - bt2[0, 2:]
    bt2[1, 1:] = 0
    np.testing.assert_array_equal(_port(q, kp, vp, bt2, ln), base)


@pytest.mark.parametrize("window,sink", [(0, 0), (8, 4), (5, 0)])
def test_decode_attention_window_sink_matches_jax(window, sink):
    rng = np.random.default_rng(window + sink)
    B, S, Hq, Hkv, D = 3, 40, 4, 2, 16
    q = rng.standard_normal((B, 1, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    ln = np.asarray([40, 17, 3], np.int32)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), n_kv_heads=Hkv,
                           cache_len=torch.from_numpy(ln), window=window,
                           sink=sink).numpy()
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_kv_heads=Hkv,
        cache_len=jnp.asarray(ln), window=window, sink=sink))
    np.testing.assert_allclose(got, want, **TOL_ORACLE)
    # a scalar cache length broadcasts over the batch
    got_s = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), n_kv_heads=Hkv,
                             cache_len=17, window=window, sink=sink)
    want_s = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_kv_heads=Hkv,
        cache_len=17, window=window, sink=sink))
    np.testing.assert_allclose(got_s.numpy(), want_s, **TOL_ORACLE)


def test_length_zero_behaviours():
    """A stream of length 0: the Pallas kernel gives 0 (l == 0 -> 1),
    the oracle NaN (softmax over no visible token).  The port's plain
    version follows the oracle; its CUDA kernel follows the Pallas
    kernel (held on the card in test_torch_kernel_cuda.py)."""
    q, kp, vp, bt, _ = _case(3, 4, 2, 16, 8, 4, 16, seed=11)
    ln = np.asarray([5, 0, 32], np.int32)
    got = _port(q, kp, vp, bt, ln)
    pallas = _jax(paged_decode_attention_pallas, q, kp, vp, bt, ln,
                  interpret=True)
    oracle = _jax(jax_decode_ref, q, kp, vp, bt, ln)
    assert np.isnan(got[1]).all() and np.isnan(oracle[1]).all()
    assert (pallas[1] == 0).all()
    live = [0, 2]
    np.testing.assert_allclose(got[live], oracle[live], **TOL_ORACLE)
    np.testing.assert_allclose(got[live], pallas[live], **TOL_PALLAS)


def test_wrapper_refuses_a_device_without_kernel():
    q = torch.zeros((1, 2, 16), device="meta")
    kp = torch.zeros((2, 4, 1, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_decode_attention(q, kp, kp,
                                   torch.zeros((1, 2), dtype=torch.int32,
                                               device="meta"),
                                   torch.ones((1,), dtype=torch.int32,
                                              device="meta"))


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("bfloat16", "float8_e4m3fn"), ("float32", "float8_e4m3fn"),
    ("bfloat16", "float32"), ("float32", "bfloat16")],
    ids=["bf16-e4m3", "f32-e4m3", "bf16-f32", "f32-bf16"])
def test_paged_decode_mixed_dtypes_match_jax(q_dtype, kv_dtype):
    """q and pages of different dtypes, e4m3 pages among them: the
    reference's Pallas kernel widens all three to fp32 and returns q's
    dtype; so does the port (its plain version here, its CUDA kernel on
    the card).  Inputs rounded to their dtypes once, in JAX, and handed
    to both as the same bits."""
    q, kp, vp, bt, ln = _case(2, 4, 2, 16, 8, 4, 16, seed=29)
    jq = jnp.asarray(q).astype(q_dtype)
    jk, jv = (jnp.asarray(x * 4).astype(kv_dtype) for x in (kp, vp))
    pallas = np.asarray(paged_decode_attention_pallas(
        jq, jk, jv, jnp.asarray(bt), jnp.asarray(ln), interpret=True))
    assert pallas.dtype == jq.dtype

    def to_torch(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            getattr(torch, str(x.dtype)))

    got = ops.paged_decode_attention(to_torch(jq), to_torch(jk),
                                     to_torch(jv), torch.from_numpy(bt),
                                     torch.from_numpy(ln))
    assert got.dtype == getattr(torch, q_dtype)
    got = got.float().numpy()
    want = pallas.astype(np.float32)
    print(f"max |port - pallas| {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, **TOL_PALLAS)


# ---------------------------------------------------------------------------
# the tensor-core path's split over the sequence (flash-decoding)
# ---------------------------------------------------------------------------

PAGE, N_ENTRIES, UNIT = 16, 2048, 2048


@pytest.mark.parametrize("length", [0, 1, PAGE - 1, UNIT - 1, UNIT,
                                    UNIT + 1, 32768, 40000, -3],
                         ids=["0", "1", "page-1", "unit-1", "unit",
                              "unit+1", "32768", "past-table", "negative"])
def test_unit_plan_covers_every_visible_token_once(length):
    """``decode_units`` (the grid the kernel launches, as a plan): every
    token before ``lengths[b]`` (clamped to the table's n * page) lies in
    exactly one unit, no unit reaches a token at or past it, units start
    on a page boundary, and a stream of length 0 has no unit."""
    lengths = [length, 7]
    units = ops.decode_units(lengths, N_ENTRIES, PAGE, UNIT)
    for b, ln in enumerate(lengths):
        ln = min(max(ln, 0), N_ENTRIES * PAGE)
        covered = np.zeros(N_ENTRIES * PAGE, np.int32)
        for bb, u, first_page, t0, count in units:
            if bb != b:
                continue
            assert t0 == u * UNIT and first_page * PAGE == t0
            assert 0 < count <= UNIT and t0 + count <= ln
            covered[t0:t0 + count] += 1
        assert (covered[:ln] == 1).all() and (covered[ln:] == 0).all()


@pytest.mark.parametrize("B,Hkv,tokens,unit", [
    (128, 8, 32768, 2048),      # minitron-8b decode_32k: 16,384 units
    (1, 8, 32768, 256),         # one long stream: 128 units of 256
    (2, 8, 4096, 256),
    (64, 8, 32768, 2048),
    (16, 4, 32768, 2048),       # 1,024 units: enough
    (8, 4, 32768, 1024),
    (4, 2, 64, 256),            # a short table: one unit each
])
def test_unit_size_spreads_long_streams(B, Hkv, tokens, unit):
    got = ops.decode_unit_tokens(B, Hkv, tokens)
    assert got == unit
    assert got % ops.DECODE_TILE == 0 and got <= ops.DECODE_MAX_UNIT


@pytest.mark.parametrize("case", CASES,
                         ids=["gqa2", "mha", "gqa4", "length1"])
@pytest.mark.parametrize("unit", [8, 16, 32])
def test_split_partials_combined_match_pallas(case, unit):
    """Per-unit fp32 partials (m, l, acc) of the split over the sequence,
    merged by the plain combine, against the reference's Pallas kernel
    in interpret mode at its test shapes, within 1e-5: splitting the
    online softmax at unit boundaries changes the summation order only."""
    *shape, lengths = case
    q, kp, vp, bt, ln = _case(*shape, seed=sum(shape) + unit,
                              lengths=lengths)
    tq, tk, tv, tb, tl = (torch.from_numpy(a) for a in (q, kp, vp, bt, ln))
    m, l, acc = ref.paged_decode_partials_ref(tq, tk, tv, tb, tl, unit)
    units = -(-shape[5] * shape[4] // unit)
    assert m.shape == (shape[0], shape[1], units)
    # a unit wholly past a stream's length contributes nothing
    for b, length in enumerate(ln):
        dead = np.arange(units) * unit >= length
        assert (m[b][:, dead] == ref.NEG_INF).all()
        assert (l[b][:, dead] == 0).all() and (acc[b][:, dead] == 0).all()
    got = ref.combine_decode_partials(m, l, acc).numpy()
    pallas = _jax(paged_decode_attention_pallas, q, kp, vp, bt, ln,
                  interpret=True)
    print(f"max |split+combine - pallas| {np.abs(got - pallas).max():.3g}")
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_split_combine_gives_zero_for_length_zero():
    """A stream of length 0 has no visible unit: the combine gives 0, as
    the Pallas kernel and the CUDA kernel do."""
    q, kp, vp, bt, _ = _case(3, 4, 2, 16, 8, 4, 16, seed=12)
    ln = np.asarray([5, 0, 32], np.int32)
    tq, tk, tv, tb, tl = (torch.from_numpy(a) for a in (q, kp, vp, bt, ln))
    got = ref.combine_decode_partials(
        *ref.paged_decode_partials_ref(tq, tk, tv, tb, tl, 8)).numpy()
    pallas = _jax(paged_decode_attention_pallas, q, kp, vp, bt, ln,
                  interpret=True)
    assert (got[1] == 0).all() and (pallas[1] == 0).all()
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
