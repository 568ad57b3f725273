"""Int8 gradient compression with error feedback
(``repro_torch.train.compression``) against the JAX reference's
``train/compression.py``, on the CPU.

* ``compress`` / ``decompress`` bit for bit with JAX's on seeded inputs:
  the int8 blocks, the fp32 scales, the residual and the dequantized
  values, for whole and padded blocks, fp32 and bf16, and over 5 steps of
  error feedback; ties round half to even on both sides.
* ``compressed_psum`` over spawned gloo ranks: at world 2 it equals the
  mean of JAX's per-rank decompressions bit for bit (a two-term sum has
  one order), and so does its sum over the ``pod`` dim's group of a
  (2, 2) mesh at world 4; over all 4 ranks it is within 2 ulps of the
  numpy mean at the scale of the summed magnitudes (gloo's summation
  order is its own: each order rounds 3 partial sums, and where the
  terms cancel a reordered sum moves the small mean by many of its own
  ulps; measured: 2).  The new error buffer
  equals JAX's bit for bit.

Spawned ranks meet through ``init_method="file://<tmp_path>/..."`` and
are joined with a deadline of their own
(``test_torch_sharding.run_spawned``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as jc
from repro_torch.train import compression as tc
from test_torch_sharding import run_spawned

SHAPES = [(2048,), (3, 1000), (5, 7, 33), (1,)]


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


def _draw(shape, seed, scale=1e-2):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_compress_bit_for_bit(shape, dtype):
    g = _draw(shape, 0)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    q, s, r = tc.compress(tg)
    jq, js, jr = jc.compress(jg)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert r.dtype == tg.dtype and tuple(r.shape) == shape
    np.testing.assert_array_equal(_bits(r), _jbits(jr))
    d = tc.decompress(q, s, shape, tg.dtype)
    jd = jc.decompress(jq, js, shape, jg.dtype)
    np.testing.assert_array_equal(_bits(d), _jbits(jd))


def test_error_feedback_five_steps():
    shape = (3, 1000)
    err = torch.zeros(shape)
    jerr = jnp.zeros(shape)
    for step in range(5):
        g = _draw(shape, 10 + step)
        q, s, err = tc.compress(torch.from_numpy(g) + err)
        jq, js, jerr = jc.compress(jnp.asarray(g) + jerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
        np.testing.assert_array_equal(
            tc.decompress(q, s, shape).numpy(),
            np.asarray(jc.decompress(jq, js, shape)))


def test_round_half_to_even():
    """A block whose largest magnitude is 127 has scale 1: its halves
    round to the even integer in both frameworks."""
    g = np.zeros(1024, np.float32)
    g[:6] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
    q, _, _ = tc.compress(torch.from_numpy(g))
    jq, _, _ = jc.compress(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy()[0, :6], [127, 0, 2, 2, 0, -4])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_init_error_buffers():
    tree = {"a": torch.ones(3, dtype=torch.bfloat16),
            "b": {"c": torch.ones(2, 2)}}
    buf = tc.init_error_buffers(tree)
    assert buf["a"].dtype == torch.bfloat16 and not buf["a"].any()
    assert tuple(buf["b"]["c"].shape) == (2, 2) and not buf["b"]["c"].any()


# ---------------------------------------------------------------------------
# compressed_psum across gloo ranks
# ---------------------------------------------------------------------------

PSUM_SHAPE = (3, 1000)


def _psum_rank(rank, world, init, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        g = torch.from_numpy(_draw(PSUM_SHAPE, 100 + rank))
        err = torch.from_numpy(_draw(PSUM_SHAPE, 200 + rank, 1e-4))
        avg, new_err = tc.compressed_psum(g, err)
        res = {"avg": avg.numpy(), "err": new_err.numpy()}
        if world == 4:
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("pod", "data"))
            res["pod_avg"] = tc.compressed_psum(
                g, err, mesh.get_group("pod"))[0].numpy()
            res["coord"] = np.array(mesh.get_coordinate())
        np.savez(f"{out}.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def _jax_rank(rank):
    g = jnp.asarray(_draw(PSUM_SHAPE, 100 + rank))
    err = jnp.asarray(_draw(PSUM_SHAPE, 200 + rank, 1e-4))
    q, s, new_err = jc.compress(g + err)
    return np.asarray(jc.decompress(q, s, PSUM_SHAPE)), np.asarray(new_err)


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_matches_jax(world, tmp_path):
    out = str(tmp_path / "psum")
    run_spawned(_psum_rank, world, tmp_path, out)
    deq = [_jax_rank(r) for r in range(world)]
    total = deq[0][0].copy()
    for d, _ in deq[1:]:
        total = total + d
    want = total / np.float32(world)
    for rank in range(world):
        got = np.load(f"{out}.{rank}.npz")
        np.testing.assert_array_equal(got["err"], deq[rank][1])
        if world == 2:
            np.testing.assert_array_equal(got["avg"], want)
        else:
            # 2 ulps at the scale of the sum (of the terms' magnitudes,
            # then averaged): each order rounds 3 partial sums, and where
            # the terms cancel the mean is far smaller than its partial
            # sums, so a reordered sum moves it by many of its own ulps
            scale = np.sum([np.abs(d) for d, _ in deq], axis=0)
            ulp = np.spacing(scale / np.float32(world))
            diff = np.abs(got["avg"] - want)
            assert np.all(diff <= 2 * ulp), float(np.max(diff / ulp))
            # the pod group of a (2, 2) (pod, data) mesh: ranks r and r^2
            pair = [r for r in range(4) if r % 2 == rank % 2]
            pw = (deq[pair[0]][0] + deq[pair[1]][0]) / np.float32(2)
            np.testing.assert_array_equal(got["pod_avg"], pw)
