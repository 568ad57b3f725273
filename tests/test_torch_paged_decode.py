"""The port's paged decode attention against the JAX reference's, on the
CPU: ``ops.paged_decode_attention`` (the plain version on CPU tensors)
against ``paged_decode_attention_pallas(interpret=True)`` and the
reference's oracle, at the reference test's three shapes and length 1;
``models.attention.decode_attention`` (the oracle's inner function)
with a window and a sink; and the length-0 behaviours.

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
from repro_torch.kernels.paged_attention import ops
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
