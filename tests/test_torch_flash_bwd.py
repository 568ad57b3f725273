"""The flash kernel's gradient on the CPU: the plain backward
``flash_mha_bwd_ref`` (FlashAttention-2's recompute formulas from the
forward's log-sum-exp) and ``FlashMHA`` through its CPU branch (the
wiring the card runs: saved tensors, the GQA sum into dK / dV, no
gradient for the mode arguments) against ``jax.vjp`` of the reference's
``flash_mha_ref`` in every mode the kernel takes (causal with and
without ``q_offset``, sink + window, the rho keep matrix, non-causal,
GQA, rows that see nothing), at 1e-5 (rtol and atol, fp32; the two
differ in summation order only); the plain backward's ``round_bf16``
variant (the tensor-core kernel's arithmetic: P and dS rounded to bf16
before the products that take them) bit for bit the default with the
option off and within 2^-6 of each gradient's largest magnitude of the
``jax.vjp`` with it on (one bf16 rounding of each P and dS, relative
2^-9, summed over many terms of both signs); the backward's kernel
choice (``bwd_kernel_path``) and grid (``bwd_blocks``) on both paths;
a float64 ``gradcheck`` of
``FlashMHA`` at a tiny shape; and the autograd guard of the wrappers
whose kernels have no backward (``kernels.common.grad``).  The card's
kernels are in ``tests/test_torch_kernel_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.common.grad import no_grad_through
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
# the round_bf16 plain backward against jax.vjp, relative to each
# gradient's largest magnitude (the chip check's gate on the tensor-core
# kernel's gap to the fp32 gradient)
TOL_ROUNDED = 2.0 ** -6

# (name, B, Sq, Skv, Hq, Hkv, D, mode); block sizes as flash_mha clips them
MODES = [
    ("causal blocked", 1, 64, 64, 4, 2, 16,
     dict(causal=True, block_q=32, block_kv=32)),
    ("causal q_offset", 2, 64, 96, 4, 4, 16,
     dict(causal=True, q_offset=32, block_q=32, block_kv=32)),
    ("causal direct", 1, 12, 12, 2, 1, 16, dict(causal=True)),
    ("sink + window", 1, 64, 64, 4, 4, 16,
     dict(causal=True, window=16, sink=8, block_q=32, block_kv=32)),
    ("rho 0.7 keep matrix", 1, 64, 64, 4, 4, 16,
     dict(causal=True, sparsity=0.7, block_q=16, block_kv=16)),
    ("rho 0.5 q_offset", 1, 32, 64, 2, 2, 16,
     dict(causal=True, q_offset=32, sparsity=0.5, block_q=16,
          block_kv=16)),
    ("non-causal GQA", 2, 24, 40, 4, 2, 16, dict(causal=False)),
    ("non-causal D 64", 1, 20, 33, 2, 2, 64, dict(causal=False)),
    ("rows that see nothing", 1, 8, 16, 2, 2, 16,
     dict(causal=True, q_offset=14, window=4)),
]


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                  (B, Sq, Hq, D)))


def _jax_vjp(q, k, v, do, hkv, mode):
    out, vjp = jax.vjp(
        lambda a, b, c: jref.flash_mha_ref(a, b, c, n_kv_heads=hkv, **mode),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("name,B,Sq,Skv,Hq,Hkv,D,mode", MODES,
                         ids=[m[0] for m in MODES])
def test_bwd_ref_matches_jax_vjp(name, B, Sq, Skv, Hq, Hkv, D, mode):
    q, k, v, do = _inputs(B, Sq, Skv, Hq, Hkv, D)
    jout, jgrads = _jax_vjp(q, k, v, do, Hkv, mode)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = ref.flash_mha_ref(tq, tk, tv, n_kv_heads=Hkv,
                                 return_lse=True, **mode)
    np.testing.assert_allclose(out.numpy(), jout, **TOL)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    got = ref.flash_mha_bwd_ref(tq, tk, tv, out, lse, tdo, n_kv_heads=Hkv,
                                **mode)
    for g, w in zip(got, jgrads):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("name,B,Sq,Skv,Hq,Hkv,D,mode", MODES,
                         ids=[m[0] for m in MODES])
def test_flash_mha_autograd_cpu_matches_jax_vjp(name, B, Sq, Skv, Hq, Hkv, D,
                                                mode):
    q, k, v, do = _inputs(B, Sq, Skv, Hq, Hkv, D, seed=1)
    jout, jgrads = _jax_vjp(q, k, v, do, Hkv, mode)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_mha(tq, tk, tv, n_kv_heads=Hkv, **mode)
    assert out.grad_fn is not None and "FlashMHA" in type(out.grad_fn).__name__
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    out.backward(torch.from_numpy(do))
    for t, w in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), w, **TOL)


def test_lse_is_the_rows_logsumexp():
    """lse = log sum exp of each row's scaled visible scores, -inf for a
    row that sees nothing (dense, against torch.logsumexp)."""
    q, k, v, _ = _inputs(1, 8, 16, 2, 2, 16, seed=2)
    mode = dict(causal=True, q_offset=14, window=4)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = ref.flash_mha_ref(tq, tk, tv, n_kv_heads=2, return_lse=True,
                               **mode)
    vis = ref.visibility(8, 16, sparsity=0.0, sink=0, block_q=8,
                         block_kv=16, **mode)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / 4.0
    want = torch.logsumexp(torch.where(vis, s, -torch.inf), dim=-1)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    assert bool(torch.isinf(lse).any()) and bool(torch.isfinite(lse).any())
    fin = torch.isfinite(want)
    torch.testing.assert_close(lse[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", [
    dict(causal=True, window=3, sink=1), dict(causal=False),
    dict(causal=True, q_offset=2, sparsity=0.5, block_q=2, block_kv=2)],
    ids=["sink + window", "non-causal", "rho q_offset"])
def test_gradcheck_float64(mode):
    """``FlashMHA``'s CPU branch in float64 against numerical
    derivatives: the backward formulas are the forward's gradient."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, 4, 16), generator=g, dtype=torch.float64)
    k = torch.randn((1, 6, 2, 16), generator=g, dtype=torch.float64)
    v = torch.randn((1, 6, 2, 16), generator=g, dtype=torch.float64)
    ins = tuple(t.requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.flash_mha(a, b, c, n_kv_heads=2, **mode), ins,
        eps=1e-6, atol=1e-6, rtol=1e-5)


def test_grad_path_forward_is_the_plain_forward():
    """Under grad the output equals the no-grad call's bit for bit, and
    no gradient reaches an input that does not ask for one."""
    q, k, v, do = _inputs(2, 24, 40, 4, 2, 16, seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = ops.flash_mha(tq, tk, tv, n_kv_heads=2, causal=False)
    assert plain.grad_fn is None
    tk.requires_grad_()
    out = ops.flash_mha(tq, tk, tv, n_kv_heads=2, causal=False)
    assert torch.equal(out.detach(), plain)
    out.backward(torch.from_numpy(do))
    assert tk.grad is not None and tq.grad is None and tv.grad is None
    with torch.no_grad():
        assert ops.flash_mha(tq, tk, tv, n_kv_heads=2,
                             causal=False).grad_fn is None


@pytest.mark.parametrize("name,B,Sq,Skv,Hq,Hkv,D,mode", MODES,
                         ids=[m[0] for m in MODES])
def test_bwd_ref_round_bf16_off_is_the_default(name, B, Sq, Skv, Hq, Hkv,
                                               D, mode):
    """``round_bf16=False`` is the plain backward as the CUDA-core kernel
    computes it, bit for bit, and ``round_bf16=True`` really rounds."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(B, Sq, Skv, Hq, Hkv, D, seed=4))
    out, lse = ref.flash_mha_ref(q, k, v, n_kv_heads=Hkv, return_lse=True,
                                 **mode)
    default = ref.flash_mha_bwd_ref(q, k, v, out, lse, do, n_kv_heads=Hkv,
                                    **mode)
    off = ref.flash_mha_bwd_ref(q, k, v, out, lse, do, n_kv_heads=Hkv,
                                round_bf16=False, **mode)
    on = ref.flash_mha_bwd_ref(q, k, v, out, lse, do, n_kv_heads=Hkv,
                               round_bf16=True, **mode)
    assert all(torch.equal(a, b) for a, b in zip(default, off))
    assert not all(torch.equal(a, b) for a, b in zip(default, on))


@pytest.mark.parametrize("name,B,Sq,Skv,Hq,Hkv,D,mode", MODES,
                         ids=[m[0] for m in MODES])
def test_bwd_ref_round_bf16_near_jax_vjp(name, B, Sq, Skv, Hq, Hkv, D,
                                         mode):
    """The tensor-core kernel's plain version against the exact gradient
    of the reference's ``flash_mha_ref``: within TOL_ROUNDED of each
    gradient's largest magnitude; rows that see nothing stay exactly 0."""
    q, k, v, do = _inputs(B, Sq, Skv, Hq, Hkv, D, seed=5)
    _, jgrads = _jax_vjp(q, k, v, do, Hkv, mode)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = ref.flash_mha_ref(tq, tk, tv, n_kv_heads=Hkv,
                                 return_lse=True, **mode)
    got = ref.flash_mha_bwd_ref(tq, tk, tv, out, lse, tdo, n_kv_heads=Hkv,
                                round_bf16=True, **mode)
    for g, w in zip(got, jgrads):
        top = float(np.abs(w).max())
        assert float(np.abs(g.numpy() - w).max()) <= TOL_ROUNDED * top
    dead = torch.isinf(lse).permute(0, 2, 1)                # [B, Sq, Hq]
    assert not bool(got[0][dead].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 64, 96, 128])
def test_bwd_kernel_path(dtype, D):
    """bf16 at the full-width head dims takes the tensor-core backward,
    the rest the CUDA cores: the forward's rule."""
    want = "wgmma" if dtype == torch.bfloat16 and D != 16 else "cuda_cores"
    assert ops.bwd_kernel_path(dtype, D) == want == ops.kernel_path(dtype, D)


def test_flash_mha_bwd_refuses_a_path_it_cannot_run():
    """``path="wgmma"`` only where the tensor cores run; a name of no
    kernel raises too (both before any launch)."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(1, 8, 8, 2, 2, 16, seed=6))
    lse = torch.zeros((1, 2, 8))
    for path in ("wgmma", "tensor_cores"):
        with pytest.raises(ValueError, match="no .* kernel"):
            ops.flash_mha_bwd(q, k, v, q, lse, do, n_kv_heads=2, path=path)


def test_bwd_blocks():
    # minicpm-2b's training attention: 36 heads, 4,096 tokens, B 2
    assert ops.bwd_blocks(2, 4096, 4096, 36, 36) == (4608, 4608)
    # whisper-medium's encoder: 1,500 keys end in a partial tile
    assert ops.bwd_blocks(2, 1500, 1500, 16, 16) == (768, 768)
    assert ops.bwd_blocks(1, 2640, 5357, 12, 4) == (4 * 84, 12 * 42)


@pytest.mark.parametrize("path,shape,want", [
    ("cuda_cores", (2, 4096, 4096, 36, 36), (4608, 4608)),
    # the tensor cores: 128 keys a dK/dV block, 128 queries a dQ block
    ("wgmma", (2, 4096, 4096, 36, 36), (2304, 2304)),
    ("wgmma", (2, 1500, 1500, 16, 16), (384, 384)),
    ("wgmma", (1, 2640, 5357, 12, 12), (12 * 42, 12 * 21)),
    ("wgmma", (1, 2640, 2717, 12, 4), (4 * 22, 12 * 21)),
], ids=["cuda-cores-minicpm", "wgmma-minicpm", "wgmma-whisper",
        "wgmma-ardit", "wgmma-gqa"])
def test_bwd_blocks_on_both_paths(path, shape, want):
    assert ops.bwd_blocks(*shape, path=path) == want


# ---------------------------------------------------------------------------
# the guard of the wrappers without a backward
# ---------------------------------------------------------------------------

def test_no_grad_through_raises_under_grad():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd: the CUDA kernel has no "
                                           "backward") as e:
        no_grad_through("ssd", torch.ones(2), x, None)
    assert "ROADMAP section 2" in str(e.value)


def test_no_grad_through_silent_without_grad():
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        no_grad_through("ssd", x)
    no_grad_through("ssd", torch.ones(3), x.detach(), None, 1.0)
    with torch.inference_mode():
        no_grad_through("paged_decode_attention", torch.ones(3))


def test_plain_versions_stay_differentiable_on_the_cpu():
    """The guard sits on the CUDA branch only: the CPU plain version of
    the SSD scan keeps its autograd graph (the CPU training path)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 8, 2, 4), generator=g, requires_grad=True)
    dt = torch.rand((1, 8, 2), generator=g)
    A = -torch.rand((2,), generator=g)
    B = torch.randn((1, 8, 1, 4), generator=g)
    C = torch.randn((1, 8, 1, 4), generator=g)
    y, _ = ssd_ops.ssd(x, dt, A, B, C, chunk=4)
    assert y.grad_fn is not None
    y.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_profile_train_tells_the_backward_from_the_forward():
    from repro_torch.launch.profile_train import category
    bwd = ["void (anonymous namespace)::bwd_dkdv_kernel<64, __nv_bfloat16>",
           "void (anonymous namespace)::bwd_delta_kernel<16, float>",
           "void (anonymous namespace)::bwd_dq_kernel<128, float>",
           # the tensor-core kernels
           "void (anonymous namespace)::bwd_prep_kernel<64>",
           "void (anonymous namespace)::bwd_dkdv_wgmma_kernel<128>",
           "void (anonymous namespace)::bwd_dq_wgmma_kernel<96>"]
    fwd = "void (anonymous namespace)::tc::flash_mha_wgmma_kernel<64>"
    for name in bwd:
        assert category(name) == "flash_mha backward (CUDA kernel)", name
    assert category(fwd) == "flash_mha (CUDA kernel)"
    assert category("ampere_bf16_s16816gemm_bf16_128x64") == "matmul / gemv"
