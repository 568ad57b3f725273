"""The port's scaled fp8 matmul against the JAX reference's, on the CPU.

``quantize_fp8`` must equal ``quantize_fp8_ref`` bit for bit (the fp8
bytes and the fp32 scales), on ordinary rows, a zero row, rows far past
e4m3's range, tiny rows and a row holding inf (whose NaN quotients must
sit where the reference's do); ``fp8_matmul`` / ``fp8_scaled_matmul``
(the plain version on CPU tensors) must match
``fp8_matmul_pallas(interpret=True)`` at the reference test's shapes
within 1e-5 (rtol and atol, the reference test's limit) and the oracle
at a ragged shape the Pallas kernel refuses; and the quantization error
stays within the reference test's bound.  Inputs come from a numpy
generator.
"""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.kernels.fp8_matmul.kernel import fp8_matmul_pallas
from repro.kernels.fp8_matmul.ref import fp8_matmul_ref as jax_matmul_ref
from repro.kernels.fp8_matmul.ref import quantize_fp8_ref as jax_quantize
from repro_torch.kernels import fp8_matmul, quantize_fp8
from repro_torch.kernels.fp8_matmul import ops

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _bytes(q):
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _special(rng):
    x = rng.standard_normal((12, 40), dtype=np.float32)
    x[1] = 0.0                                    # zero row
    x[2] *= 1e4                                   # far past 448
    x[3, 5] = 3e38                                # one huge value
    x[4] *= 1e-20                                 # below the 1e-12 floor
    x[5, 7] = np.inf                              # overflow: NaN quotient
    x[6, 3] = -np.inf
    x[7, ::3] = 448.0
    return x


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_exact_against_jax(axis, dtype):
    rng = np.random.default_rng(axis)
    x = _special(rng)
    if axis == 0:
        x = np.ascontiguousarray(x.T)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s = quantize_fp8(xt, axis=axis)
    qj, sj = jax_quantize(xj, axis)
    assert q.dtype == torch.float8_e4m3fn and s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    got, want = _bytes(q), _bytes(qj)
    # NaN's sign bit is not part of the contract (the host's default
    # NaN decides it): NaN where the reference has NaN, bytes elsewhere
    nan_t = np.isnan(q.float().numpy())
    nan_j = np.isnan(np.asarray(qj.astype(jnp.float32)))
    np.testing.assert_array_equal(nan_t, nan_j)
    np.testing.assert_array_equal(got[~nan_t], want[~nan_j])
    assert nan_t.any()              # the inf rows did reach the cast


@pytest.mark.parametrize("M,K,N", [(64, 64, 64), (128, 256, 64),
                                   (32, 32, 32)])
def test_fp8_matmul_matches_pallas(M, K, N):
    rng = np.random.default_rng(M + K + N)
    x = rng.standard_normal((M, K), dtype=np.float32)
    w = rng.standard_normal((K, N), dtype=np.float32)
    xq, sx = jax_quantize(jnp.asarray(x), 1)
    wq, sw = jax_quantize(jnp.asarray(w), 0)
    want = np.asarray(fp8_matmul_pallas(xq, wq, sx, sw, block_m=32,
                                        block_n=32, block_k=32,
                                        interpret=True))
    before = ops.fp8_scaled_matmul.launches
    got = fp8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert ops.fp8_scaled_matmul.launches == before       # plain on CPU
    assert got.dtype == torch.float32 and got.shape == (M, N)
    print(f"max |port - pallas| {np.abs(got.numpy() - want).max():.3g}")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the same fp8 bytes and scales through the quantized entry point
    qx = torch.from_numpy(_bytes(xq).copy()).view(torch.float8_e4m3fn)
    qw = torch.from_numpy(_bytes(wq).copy()).view(torch.float8_e4m3fn)
    got_q = ops.fp8_scaled_matmul(qx, qw, torch.from_numpy(np.array(sx)),
                                  torch.from_numpy(np.array(sw)))
    np.testing.assert_allclose(got_q.numpy(), want, **TOL)


def test_fp8_matmul_ragged_and_bf16_against_oracle():
    """M, K, N that divide no block (the CUDA kernel takes them; the
    Pallas kernel asserts divisibility): against the reference's oracle,
    in fp32 and rounded once to bf16."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((50, 40), dtype=np.float32)
    w = rng.standard_normal((40, 24), dtype=np.float32)
    xq, sx = jax_quantize(jnp.asarray(x), 1)
    wq, sw = jax_quantize(jnp.asarray(w), 0)
    want = np.asarray(jax_matmul_ref(xq, wq, sx, sw))
    got = fp8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got16 = fp8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                       out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got16.float().numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def test_quantization_error_bounded():
    x = np.random.default_rng(3).standard_normal((64, 128), dtype=np.float32)
    xq, sx = quantize_fp8(torch.from_numpy(x), 1)
    deq = xq.float() * sx
    # e4m3 relative error within a scaled block is < 2^-2 of the max
    err = float((deq - torch.from_numpy(x)).abs().max())
    assert err < float(np.abs(x).max()) * 0.07


def test_wrapper_refuses_a_device_without_kernel():
    q = torch.zeros((4, 4), device="meta").to(torch.float8_e4m3fn)
    s = torch.ones((4, 1), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.fp8_scaled_matmul(q, q, s, s.T)
