"""The port's SSD chunked scan against the JAX reference: the plain
version ``ssd_ref`` against the reference's ``ssd_ref`` and its TPU
kernel ``ssd_pallas`` in interpret mode at the shapes of
``tests/test_kernels.py::TestSSD`` (ragged S included), ``init_state``
and its continuation, S shorter than the chunk, n_groups > 1 (the plain
version only), bf16 inputs; ``ssd_decode_ref`` against the reference's;
the chunked scan against the port's own per-token recurrence; the
wrapper's dispatch on the CPU; and ``ssd_kernel_emulation``, the scan as
the tensor-core kernel factors and rounds it (one C B^T per chunk, the
fp32 operands fed to bf16 products as one rounding or a hi + lo pair,
the state chained in fp32), against ``ssd_pallas`` in interpret mode at
the card's limits (2 bf16 ulps on y, 1e-4 on the final state), which
settles the kernel's operand plan.  Inputs come from numpy seeds.

Tolerance: 1e-5 (rtol and atol) in fp32 — both sides accumulate in fp32
and differ in summation order only (measured <= 2e-6 relative); bf16
outputs within one bf16 ulp (2^-8 relative: both round an fp32 result
that differs in summation order only).  The chunked scan against the
per-token recurrence: 2e-4, the reference's own limit for those two
summation orders (measured 3.8e-6 at y up to ~10).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_pallas
from repro.kernels.ssd_scan.ref import ssd_decode_ref as jax_decode
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models.convert import tensor_from_numpy

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, S, H, P, N, *, G=1, init=False, seed=0):
    """x, dt (softplus of a normal), A < 0, Bm, Cm and an optional
    init_state, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)))).astype(np.float32)
    Bm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32) if init else None
    return x, dt, A, Bm, Cm, s0


def _torch(x, dt, A, Bm, Cm, s0, chunk):
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, dt, A, Bm, Cm, s0)]
    y, f = ref.ssd_ref(*t[:5], chunk=chunk, init_state=t[5])
    return y.numpy(), f.numpy()


def _jax(fn, x, dt, A, Bm, Cm, s0, chunk, **kw):
    j = [None if a is None else jnp.asarray(a)
         for a in (x, dt, A, Bm, Cm, s0)]
    y, f = fn(*j[:5], chunk=chunk, init_state=j[5], **kw)
    return np.asarray(y), np.asarray(f)


# the shapes of tests/test_kernels.py::TestSSD::test_vs_ref, then
# init_state (test_init_state_continuation's shape) and S < chunk
CASES = {
    "B2-S64-H4-P16-N8-c16": ((2, 64, 4, 16, 8), 16, False),
    "B1-S100-H2-P8-N16-c32-ragged": ((1, 100, 2, 8, 16), 32, False),
    "B2-S33-H3-P8-N4-c8-ragged": ((2, 33, 3, 8, 4), 8, False),
    "B2-S48-H2-P8-N4-c16-init": ((2, 48, 2, 8, 4), 16, True),
    "B2-S7-H2-P8-N4-c16-short": ((2, 7, 2, 8, 4), 16, False),
    "B1-S5-H3-P16-N8-c128-short-init": ((1, 5, 3, 16, 8), 128, True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_ssd_ref_matches_jax(case, against):
    shape, chunk, init = CASES[case]
    args = _inputs(*shape, init=init, seed=sum(shape))
    y, f = _torch(*args, chunk)
    if against == "ref":
        yj, fj = _jax(jax_ssd, *args, chunk)
    else:
        yj, fj = _jax(ssd_pallas, *args, chunk, interpret=True)
    assert y.shape == shape[:4] and f.shape == (shape[0], shape[2],
                                                 shape[3], shape[4])
    np.testing.assert_allclose(y, yj, **TOL)
    np.testing.assert_allclose(f, fj, **TOL)


def test_ssd_ref_groups_match_jax():
    """n_groups = 2 (the plain version repeats B/C over heads; the
    kernel takes G = 1 only)."""
    args = _inputs(2, 40, 4, 8, 4, G=2, seed=3)
    y, f = _torch(*args, 16)
    yj, fj = _jax(jax_ssd, *args, 16)
    np.testing.assert_allclose(y, yj, **TOL)
    np.testing.assert_allclose(f, fj, **TOL)


def test_init_state_continuation():
    """Scanning S tokens at once == scanning the first S1 and then the
    rest from the first part's final state (at a chunk boundary and
    off one)."""
    x, dt, A, Bm, Cm, s0 = _inputs(2, 48, 2, 8, 4, init=True, seed=4)
    y, f = _torch(x, dt, A, Bm, Cm, s0, 16)
    for s1 in (16, 21):
        ya, fa = _torch(x[:, :s1], dt[:, :s1], A, Bm[:, :s1], Cm[:, :s1],
                        s0, 16)
        yb, fb = _torch(x[:, s1:], dt[:, s1:], A, Bm[:, s1:], Cm[:, s1:],
                        fa, 16)
        np.testing.assert_allclose(np.concatenate([ya, yb], 1), y, **TOL)
        np.testing.assert_allclose(fb, f, **TOL)


def test_ssd_ref_bf16_matches_jax():
    """bf16 x/B/C: y in bf16 (both round the same fp32 result), the
    final state in fp32."""
    x, dt, A, Bm, Cm, _ = _inputs(2, 40, 3, 16, 8, seed=5)
    bf = ml_dtypes.bfloat16
    xb, Bb, Cb = (a.astype(bf) for a in (x, Bm, Cm))
    y, f = ref.ssd_ref(tensor_from_numpy(xb), torch.from_numpy(dt),
                       torch.from_numpy(A), tensor_from_numpy(Bb),
                       tensor_from_numpy(Cb), chunk=16)
    yj, fj = jax_ssd(jnp.asarray(xb), jnp.asarray(dt), jnp.asarray(A),
                     jnp.asarray(Bb), jnp.asarray(Cb), chunk=16)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
    yj = np.asarray(yj).astype(np.float32)
    np.testing.assert_allclose(y.float().numpy(), yj, rtol=2.0 ** -8,
                               atol=1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), **TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_ref_matches_jax(G):
    rng = np.random.default_rng(G)
    B, H, P, N = 3, 4, 8, 16
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)))).astype(np.float32)
    Bm = rng.normal(size=(B, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, G, N)).astype(np.float32)
    st = rng.normal(size=(B, H, P, N)).astype(np.float32)
    y, s = ref.ssd_decode_ref(*(torch.from_numpy(a)
                                for a in (x, dt, A, Bm, Cm, st)))
    yj, sj = jax_decode(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, st)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **TOL)


def test_chunked_equals_sequential():
    """The chunked scan == the per-token recurrence (the port's own
    ``ssd_decode_ref``), as the reference's test of the same name."""
    x, dt, A, Bm, Cm, _ = (torch.from_numpy(a) if a is not None else None
                           for a in _inputs(1, 19, 2, 4, 4, seed=6))
    st = torch.zeros((1, 2, 4, 4))
    ys = []
    for t in range(19):
        y, st = ref.ssd_decode_ref(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                   st)
        ys.append(y)
    y_chunk, f_chunk = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=8)
    torch.testing.assert_close(y_chunk, torch.stack(ys, 1), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(f_chunk, st, rtol=2e-4, atol=2e-4)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU tensor goes to ``ssd_ref`` (no launch counted), any G;
    ``ssd_decode`` is the plain recurrence; a device without a kernel
    raises instead of falling back."""
    args = [torch.from_numpy(a) for a in _inputs(2, 33, 3, 8, 4, G=1,
                                                 seed=7)[:5]]
    before = ops.ssd.launches
    y, f = ops.ssd(*args, chunk=8)
    y0, f0 = ref.ssd_ref(*args, chunk=8)
    assert torch.equal(y, y0) and torch.equal(f, f0)
    assert ops.ssd.launches == before
    x, dt, A, Bm, Cm = args
    st = torch.zeros((2, 3, 8, 4))
    got = ops.ssd_decode(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], st)
    want = ref.ssd_decode_ref(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], st)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd(*meta, chunk=8)


# ---------------------------------------------------------------------------
# the tensor-core kernel's factoring and rounding, emulated on the CPU
# ---------------------------------------------------------------------------

EMU_CASES = {  # (B, S, H, P, N), chunk, init_state
    "B2-S64-H4-P16-N8-c16": ((2, 64, 4, 16, 8), 16, False),
    "B1-S100-H2-P8-N16-c32-ragged": ((1, 100, 2, 8, 16), 32, False),
    "B2-S33-H3-P8-N4-c8-ragged-init": ((2, 33, 3, 8, 4), 8, True),
    "B1-S300-H3-P64-N128-c128-ragged-init": ((1, 300, 3, 64, 128), 128,
                                              True),
}


def _bf16_inputs(shape, init, seed):
    """The SSD inputs with x, B and C rounded to bf16 (the kernel's
    input type), dt scaled as the model's (softplus(normal - 3))."""
    x, dt, A, Bm, Cm, s0 = _inputs(*shape, init=init, seed=seed)
    dt = np.log1p(np.exp(np.log(np.expm1(dt)) - 3.0)).astype(np.float32)
    bf = ml_dtypes.bfloat16
    return ([a.astype(bf) for a in (x, Bm, Cm)], dt, A, s0)


def _bf16_ulp(top):
    return 2.0 ** (np.floor(np.log2(top)) - 7)


def _emulated_vs_pallas(shape, chunk, init, seed, pairs=ref.KERNEL_PAIRS):
    (xb, Bb, Cb), dt, A, s0 = _bf16_inputs(shape, init, seed)
    y, f = ref.ssd_kernel_emulation(
        tensor_from_numpy(xb), torch.from_numpy(dt), torch.from_numpy(A),
        tensor_from_numpy(Bb), tensor_from_numpy(Cb), chunk=chunk,
        init_state=None if s0 is None else torch.from_numpy(s0),
        pairs=pairs)
    yj, fj = ssd_pallas(jnp.asarray(xb), jnp.asarray(dt), jnp.asarray(A),
                        jnp.asarray(Bb), jnp.asarray(Cb), chunk=chunk,
                        init_state=None if s0 is None else jnp.asarray(s0),
                        interpret=True)
    yj = np.asarray(yj).astype(np.float32)
    fj = np.asarray(fj)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
    y_ulps = np.abs(y.float().numpy() - yj).max() / _bf16_ulp(
        np.abs(yj).max())
    f_rel = np.abs(f.numpy() - fj).max() / max(1.0, np.abs(fj).max())
    return y_ulps, f_rel


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_kernel_emulation_within_the_chip_limits(case):
    """``ssd_kernel_emulation`` (C B^T once per chunk, W, X o w and the
    entering state fed to bf16 products as hi + lo pairs, the state
    chained in fp32 chunk after chunk) against JAX's ssd_pallas in
    interpret mode, held to the limits chip_smoke.py holds the card to:
    y within 2 bf16 ulps at its largest magnitude, the final state within
    1e-4 of its largest magnitude."""
    shape, chunk, init = EMU_CASES[case]
    y_ulps, f_rel = _emulated_vs_pallas(shape, chunk, init,
                                        seed=sum(shape))
    print(f"{case}: y {y_ulps:.3f} bf16 ulps, state {f_rel:.3g}")
    assert y_ulps <= 2.0
    assert f_rel <= 1e-4


def test_chunk_state_operand_needs_the_pair():
    """Why X o w is fed as a hi + lo pair: as one bf16 rounding the final
    state misses its 1e-4 limit by an order of magnitude (each chunk's
    state feeds every later one); as a pair it is far inside."""
    shape, chunk, init = EMU_CASES["B1-S300-H3-P64-N128-c128-ragged-init"]
    _, single = _emulated_vs_pallas(shape, chunk, init, seed=5,
                                    pairs=frozenset())
    _, pair = _emulated_vs_pallas(shape, chunk, init, seed=5)
    print(f"final state: X o w single {single:.3g}, pair {pair:.3g}")
    assert single > 1e-4 and pair <= 1e-5


def test_phase_profiler_marks_every_phase_of_the_kernel():
    """``launch/profile_ssd.py --phases`` builds a copy of the kernel's
    source with a clock mark after each phase, found by the phase's line:
    every line is still there, each marked once, after a whole line."""
    from repro_torch.launch import profile_ssd

    src = ops.SOURCE.read_text()
    marked = profile_ssd.marked_source(src)
    lines = marked.splitlines()
    marks = [i for i, line in enumerate(lines) if "g_marks[(" in line]
    assert len(marks) == 1 + len(profile_ssd.MARKS)
    for i in marks:
        assert lines[i].lstrip().startswith("if ((tid & 127) == 0)")
    assert "ssd_marks_copy" in marked and len(marked) > len(src)
