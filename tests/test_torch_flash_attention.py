"""The port's flash attention against the JAX reference: ``keep_matrix``
(exact), the plain version ``flash_mha_ref`` against the TPU kernel
``flash_mha_pallas`` in interpret mode at the shapes of
``tests/test_kernels.py``, the port's ``mha`` against the reference's in
every mode (direct, causal blocked, sink + window, rho, GQA, the
AR-DiT's ragged non-causal lengths, ``kv_mask``), and the modes ``mha``
hands the kernel on the card (``attention.flash_mode``) computing what
``mha`` computes.  Inputs come from numpy seeds.  Tolerance: 1e-5 (rtol
and atol) in fp32, 3e-2 in bf16 (the reference's own bf16 limit).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_mha_pallas
from repro.kernels.flash_attention.kernel import keep_matrix as jax_keep
from repro.models.attention import mha as jax_mha
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models.attention import flash_mode, mha

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)


def _qkv(B, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in
                 ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("n_q,n_kv,causal,q_offset,window,sink,rho,bq,bkv", [
    (4, 4, True, 0, 0, 0, 0.0, 32, 32),
    (8, 8, True, 0, 0, 0, 0.7, 32, 32),
    (8, 8, True, 0, 0, 0, 0.9, 32, 32),
    (4, 12, True, 256, 0, 0, 0.6, 64, 32),
    (5, 7, False, 0, 0, 0, 0.8, 48, 96),
    (6, 6, True, 0, 64, 96, 0.7, 32, 32),
    (3, 10, True, 96, 0, 128, 0.5, 32, 64),
    (1, 9, True, 0, 0, 0, 0.7, 16, 16),
])
def test_keep_matrix_matches_jax(n_q, n_kv, causal, q_offset, window, sink,
                                 rho, bq, bkv):
    kw = dict(causal=causal, q_offset=q_offset, window=window, sink=sink,
              sparsity=rho, block_q=bq, block_kv=bkv)
    got = ops.keep_matrix(n_q, n_kv, **kw)
    np.testing.assert_array_equal(got, jax_keep(n_q, n_kv, **kw))
    assert got.dtype == np.int32 and got.shape == (n_q, n_kv)


def _pallas(q, k, v, **kw):
    q, k, v = _j(q, k, v)
    return np.asarray(flash_mha_pallas(
        q.swapaxes(1, 2), k.swapaxes(1, 2), v.swapaxes(1, 2),
        interpret=True, **kw).swapaxes(1, 2))


# the shapes and modes of tests/test_kernels.py::TestFlashAttention
PALLAS_CASES = [
    ((2, 64, 64, 4, 2, 16), dict()),
    ((1, 128, 128, 2, 2, 32), dict()),
    ((1, 96, 96, 8, 1, 64), dict()),
    ((2, 64, 64, 4, 4, 16), dict(causal=False)),
    ((1, 64, 128, 4, 4, 16), dict(q_offset=64)),
    ((1, 128, 128, 2, 1, 16), dict(window=48, sink=16)),
    ((1, 128, 128, 2, 1, 16), dict(window=40, sink=0)),
    ((1, 128, 128, 2, 1, 16), dict(window=96, sink=32)),
    ((1, 256, 256, 4, 2, 16), dict(sparsity=0.6)),
    ((1, 256, 256, 4, 2, 16), dict(sparsity=0.7)),
    ((1, 256, 256, 4, 2, 16), dict(sparsity=0.9)),
]


@pytest.mark.parametrize("shape,mode", PALLAS_CASES)
def test_ref_matches_pallas_interpret(shape, mode):
    B, Sq, Skv, Hq, Hkv, D = shape
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, D, seed=D + Sq)
    want = _pallas(q, k, v, block_q=32, block_kv=32, **mode)
    got = ref.flash_mha_ref(*_t(q, k, v), n_kv_heads=Hkv, block_q=32,
                            block_kv=32, **mode)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper sends a CPU tensor to the plain version, not the kernel
    before = ops.flash_mha.launches
    via = ops.flash_mha(*_t(q, k, v), n_kv_heads=Hkv, block_q=32,
                        block_kv=32, **mode)
    assert ops.flash_mha.launches == before
    torch.testing.assert_close(via, got, rtol=0, atol=0)


def test_ref_matches_pallas_interpret_bf16():
    q, k, v = _qkv(1, 64, 64, 2, 2, 32, seed=3)
    qb, kb, vb = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    want = _pallas(qb, kb, vb, block_q=32, block_kv=32)
    got = ref.flash_mha_ref(*(torch.from_numpy(a).to(torch.bfloat16)
                              for a in (q, k, v)), n_kv_heads=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL_BF16)


# (B, Sq, Skv, Hq, Hkv, D), mha keyword arguments
MHA_CASES = [
    ((2, 32, 32, 4, 2, 16), dict()),                          # direct causal
    ((1, 1, 70, 4, 4, 16), dict(q_offset=69)),                # decode
    ((1, 640, 640, 4, 1, 16), dict(block_q=128, block_kv=128)),  # blocked
    ((1, 256, 384, 4, 2, 16), dict(q_offset=128, block_q=64,
                                   block_kv=64)),
    ((1, 256, 256, 2, 1, 16), dict(window=48, sink=16, block_q=64,
                                   block_kv=32)),
    ((1, 64, 64, 2, 2, 16), dict(window=24, sink=8)),         # direct window
    ((1, 256, 256, 4, 2, 16), dict(sparsity=0.7, block_q=32,
                                   block_kv=64)),
    ((1, 256, 256, 4, 4, 16), dict(sparsity=0.5, window=64, block_q=64,
                                   block_kv=64)),  # rho ignored with window
    ((2, 48, 125, 4, 4, 16), dict(causal=False)),   # AR-DiT: sink + chunk
    ((1, 48, 173, 4, 4, 16), dict(causal=False)),   # ... + 1 chunk
    ((1, 48, 269, 4, 1, 16), dict(causal=False, sparsity=0.8)),  # rho ignored
    ((1, 48, 413, 4, 4, 16), dict(causal=False, window=64, sink=77)),
]


@pytest.mark.parametrize("shape,kw", MHA_CASES)
def test_mha_matches_jax_every_mode(shape, kw):
    B, Sq, Skv, Hq, Hkv, D = shape
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, D, seed=Sq + Skv)
    want = np.asarray(jax_mha(*_j(q, k, v), n_kv_heads=Hkv, **kw))
    got = mha(*_t(q, k, v), n_kv_heads=Hkv, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the mode mha hands the kernel on the card computes the same
    # function through the wrapper's plain version
    mode = flash_mode(Sq, Skv, **{**dict(causal=True, window=0, sink=0,
                                         sparsity=0.0, block_q=512,
                                         block_kv=512),
                                  **{k_: v_ for k_, v_ in kw.items()
                                     if k_ != "q_offset"}})
    via = ops.flash_mha(*_t(q, k, v), n_kv_heads=Hkv,
                        q_offset=kw.get("q_offset", 0), **mode)
    np.testing.assert_allclose(via.numpy(), want, **TOL)


def test_mha_kv_mask_matches_jax():
    q, k, v = _qkv(3, 48, 173, 4, 4, 16, seed=11)
    mask = np.random.default_rng(12).random((3, 173)) < 0.6
    mask[2] = False                                   # a row seeing nothing
    want = np.asarray(jax_mha(*_j(q, k, v), n_kv_heads=4, causal=False,
                              kv_mask=jnp.asarray(mask)))
    got = mha(*_t(q, k, v), n_kv_heads=4, causal=False,
              kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got[2].abs().max()) == 0.0


@pytest.mark.parametrize("kw,match", [
    (dict(causal=False, sparsity=0.7), "causal schedule"),
    (dict(window=64, sparsity=0.7), "causal schedule"),
    (dict(sink=32, sparsity=0.7), "causal schedule"),
    (dict(sparsity=0.7, block_q=80, block_kv=64), "divide"),
    (dict(sparsity=0.7, block_q=64, block_kv=100), "divide"),
])
def test_wrapper_rejects_modes_without_a_plain_twin(kw, match):
    q, k, v = _t(*_qkv(1, 192, 192, 2, 2, 16))
    with pytest.raises(ValueError, match=match):
        ops.flash_mha(q, k, v, n_kv_heads=2, **kw)
