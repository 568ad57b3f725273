"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.

Marked ``cuda``: each test skips on a host without an NVIDIA GPU.  This
file imports no JAX, so it also runs on a machine that has only the
port's dependencies::

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernel_cuda.py

Paged chunk attention: same inputs through the kernel (CUDA tensors) and
the plain version (the same CUDA tensors, ``ref.paged_chunk_attention_ref``);
every head dim the kernels instantiate (16, 96, 128), query and page
dtypes (fp32, bf16, fp8-e4m3 pages), GQA 4, the all-visible path,
explicit masks with and without the extent hint, a hole row and a row
that sees nothing, and the main path's 2,640-token pages with a 77-token
sink; every launch is checked to take the path ``kernel_path`` names
(``launches_tc``).  Tolerance: both accumulate in fp32 — m within 1e-4,
l within 1e-4 relative; the finalized acc / l within 1e-4 on the
CUDA-core kernel (summation order only) and within 2 bf16 ulps at its
largest magnitude on the tensor-core kernel (bf16 queries over bf16 or
e4m3 pages at D 96 / 128), which rounds P to bf16 before P V, as SDPA
and the flash kernel do; rows that see nothing are exactly (NEG_INF, 0,
0).

Flash attention: ``flash_mha`` against ``flash_mha_ref`` over head dims
16/96/128 x fp32/bf16 x each mode (non-causal at ragged AR-DiT-like
lengths, causal with ``q_offset``, sink + window, the rho keep matrix at
blocks that are not the kernels' tiles, GQA, rows that see nothing), the
tensor-core kernel (bf16 at D 96 and 128) at lengths that cross and
miss its 128-row and 128-key tiles, ``mha``'s dispatch, and the inputs
the wrapper refuses; every launch is checked to take the path
``kernel_path`` names.  Tolerance: 1e-4 for fp32 outputs; 2 bf16 ulps at
the output's largest magnitude for bf16 outputs (the CUDA-core kernel
rounds the same fp32 result once; the tensor-core kernel also rounds P
to bf16 before P V, as SDPA does, and stays within the same limit).

Paged chunk attention on head-range views ``pool[..., lo:hi, :]`` (the
elastic SP2 shards): the kernel reads the view in place and gives
exactly the partials it gives on a contiguous copy of the view, and the
plain version's within the limits above.

Paged decode attention: ``paged_decode_attention`` against
``paged_decode_attention_ref`` at the reference tests' shapes, a GQA
group of 12 (two row groups per block) and minitron-8b's attention at a
modest context, q in fp32 or bf16 over pages of fp32, bf16 or fp8-e4m3
(each widened to fp32, as the reference does), ragged lengths; a stream
of length 0 gives 0 from the kernel (the TPU kernel's rule) where the
plain version gives NaN, and table entries past a stream's length are
never read.  bf16 q over bf16 or e4m3 pages at D 64 / 128 with a group
of at most 8 takes the tensor-core kernel split over the sequence
(``launches_tc``): the edges of its split (a stream one token past a
unit boundary, one stream of 32,768 tokens, lengths 0 and 1 in one
batch, pages of 8 and 64 tokens) are held to the plain version, and
shapes outside it (D 32, a group of 12, pages of 24) are checked to
take the CUDA-core kernel.
Tolerance: 1e-5 for fp32 q (both sum in fp32; they differ in order
only), 2 bf16 ulps at the output's largest magnitude for bf16 q.

Scaled fp8 matmul: ``fp8_scaled_matmul`` against ``fp8_matmul_ref`` at
the reference tests' shapes and ragged M, N, K (including K and N that
are not multiples of 16, which take the CUDA-core kernel), fp32 and bf16
out, the two FFN shapes of the chip check on the tensor cores, and
all-positive operands at K = 4,096 (every truncation of the fp32
accumulator errs one way); ``quantize_fp8`` on the card equals
the CPU's bit for bit.  Tolerance, both kernels: every product of two
e4m3 values is exact in fp32 and both sides sum in fp32, in different
orders (the tensor-core kernel widens e4m3 to bf16, exactly, and sums on
bf16 wgmma into fp32, promoted into fp32 registers every 64 of K): at
the reference tests' three shapes the reference's own criterion,
|d| <= 1e-5 + 1e-5 |want| element by element, elsewhere |d| <= 1e-5 of
the output's largest magnitude (about ten times the order difference of
a 4,096-term sum).  In bf16 one bf16 ulp at each element's magnitude on
top.

SSD scan: ``ssd`` against ``ssd_ref`` over every (P, N) the kernel
instantiates x fp32/bf16 x/B/C, ragged S, S < chunk, ``init_state``,
x/B/C as strided views of one wider tensor (as the model passes them),
and the inputs the wrapper refuses; bf16 at (64, 128) takes the
tensor-core kernel (``launches_tc``), including a chained grid of many
more blocks than are resident, ``init_state`` with strided views and a
partial head group, and a view TMA cannot read takes the CUDA-core
kernel by ``kernel_path``.  Tolerance: y within 1e-4 of the
output's largest magnitude (at least 1e-4 absolute) in fp32, within 2
bf16 ulps at that magnitude in bf16; the fp32 final state within 1e-4
of its largest magnitude.  A scan's outputs grow with its inputs (unlike
attention's averages), so the fp32 limit is relative to them; both sides
accumulate in fp32 and differ in summation order only.
"""
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.fp8_matmul import ops as f8ops
from repro_torch.kernels.fp8_matmul import ref as f8ref
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.models.attention import mha, mha_plain, shard_heads
from repro_torch.models.kvcache import to_fp8_e4m3
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan import ref as sref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(dev, B, Sq, Hq, Hkv, D, page, n, q_dtype, kv_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * n + 3
    q = torch.randn((B, Sq, Hq, D), generator=g, device=dev).to(q_dtype)
    kp = torch.randn((P, page, Hkv, D), generator=g, device=dev)
    vp = torch.randn((P, page, Hkv, D), generator=g, device=dev)
    if kv_dtype == torch.float8_e4m3fn:
        kp, vp = to_fp8_e4m3(kp), to_fp8_e4m3(vp)
    else:
        kp, vp = kp.to(kv_dtype), vp.to(kv_dtype)
    table = torch.randint(0, P, (B, n), generator=g, device=dev,
                          dtype=torch.int32)
    mask = torch.rand((B, n * page), generator=g, device=dev) < 0.6
    return q, kp, vp, table, mask


def _check(got, want, path="cuda_cores"):
    """Partials against the plain version's: see the module docstring."""
    (m, l, acc), (m0, l0, acc0) = got, want
    dead = m0 == ref.NEG_INF
    assert torch.equal(m == ref.NEG_INF, dead)
    assert (l[dead] == 0).all() and (acc[dead] == 0).all()
    live = ~dead
    torch.testing.assert_close(m[live], m0[live], rtol=0, atol=1e-4)
    torch.testing.assert_close(l[live], l0[live], rtol=1e-4, atol=0)
    o = acc / torch.where(l == 0, 1.0, l)[..., None]
    o0 = acc0 / torch.where(l0 == 0, 1.0, l0)[..., None]
    if path == "wgmma":
        top = float(o0.abs().max())
        tol = 2 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
    else:
        tol = 1e-4
    torch.testing.assert_close(o, o0, rtol=0, atol=tol)


def _path(q, kp):
    return ops.kernel_path(q.dtype, kp.dtype, q.shape[-1],
                           q.shape[2] // kp.shape[2])


SHAPES = [  # B, Sq, Hq, Hkv, D, page, n
    (2, 70, 4, 2, 16, 77, 3),       # reduced ardit: D 16, page 77
    (3, 65, 8, 2, 16, 40, 4),       # GQA 4, ragged row tile
    (2, 96, 16, 16, 96, 100, 3),    # ardit-causal-forcing head dim
    (2, 64, 12, 12, 128, 200, 3),   # ardit-self-forcing head dim
    (3, 70, 16, 4, 128, 150, 3),    # GQA 4 at D 128, ragged row tile
]
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float8_e4m3fn)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16", "fp8"])
def test_kernel_matches_plain_version(card, shape, dtypes):
    B, Sq, Hq, Hkv, D, page, n = shape
    q, kp, vp, table, mask = _inputs(card, *shape, *dtypes, seed=D + B)
    sink, tc = page - 5, page - 11
    mask3 = mask.view(B, n, page)
    mask3[0, 1] = False                            # a fully-masked page
    if B > 1:
        table[1, -1] = table[1, 0]                 # a hole row ...
        mask3[1, -1] = False                       # ... that never shows
    if B > 2:
        mask3[-1] = False                          # a row seeing nothing
    path = _path(q, kp)
    before = (ops.paged_chunk_attention.launches,
              ops.paged_chunk_attention.launches_tc)
    for m, hint in ((None, dict(sink=sink, chunk_tokens=tc)),
                    (mask, {}),
                    (mask, dict(sink=sink, chunk_tokens=tc))):
        _check(ops.paged_chunk_attention(q, kp, vp, table, m, **hint),
               ref.paged_chunk_attention_ref(q, kp, vp, table, m, **hint),
               path)
    torch.cuda.synchronize()
    assert (ops.paged_chunk_attention.launches,
            ops.paged_chunk_attention.launches_tc) == (
        before[0] + 3, before[1] + 3 * (path == "wgmma"))


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn],
                         ids=["bf16", "fp8"])
def test_kernel_at_the_main_paths_page(card, kv_dtype):
    """The main path's geometry: 2,640-token pages (20 full 128-token
    tiles and one of 80) behind a 77-token sink (one masked tile), all
    visible and with a token mask that drops 128-token runs."""
    B, Sq, H, D, page, n, sink = 1, 200, 2, 128, 2640, 3, 77
    q, kp, vp, table, _ = _inputs(card, B, Sq, H, H, D, page, n,
                                  torch.bfloat16, kv_dtype, seed=2640)
    hint = dict(sink=sink, chunk_tokens=page)
    mask = torch.zeros((B, n, page), dtype=torch.bool, device=card)
    mask[:, 0, :sink] = True
    mask[:, 1:] = True
    mask[:, 1, 128:384] = False
    mask[:, 2, 1000:1100] = False
    before = ops.paged_chunk_attention.launches_tc
    for m in (None, mask.view(B, n * page)):
        _check(ops.paged_chunk_attention(q, kp, vp, table, m, **hint),
               ref.paged_chunk_attention_ref(q, kp, vp, table, m, **hint),
               "wgmma")
    torch.cuda.synchronize()
    assert ops.paged_chunk_attention.launches_tc == before + 2


def test_kernel_rejects_what_it_cannot_run(card):
    q, kp, vp, table, mask = _inputs(card, 1, 8, 2, 2, 48, 16, 2,
                                     torch.float32, torch.float32, 0)
    with pytest.raises(ValueError, match="head dims"):
        ops.paged_chunk_attention(q, kp, vp, table, mask)
    q, kp, vp, table, mask = _inputs(card, 1, 8, 2, 2, 16, 16, 2,
                                     torch.float32, torch.float32, 0)
    with pytest.raises(ValueError):
        ops.paged_chunk_attention(q, kp.cpu(), vp, table, mask)
    with pytest.raises(ValueError, match="layout hint"):
        ops.paged_chunk_attention(q, kp, vp, table, None)


FLASH_MODES = {  # Sq, Skv, Hq, Hkv, keyword arguments
    "noncausal-ragged": (130, 77 + 2 * 130, 4, 4, dict(causal=False)),
    "causal-offset": (96, 256, 4, 4, dict(q_offset=160)),
    "sink-window": (200, 200, 2, 2, dict(window=48, sink=16, block_q=40,
                                         block_kv=64)),
    "rho-keep": (384, 384, 4, 2, dict(sparsity=0.7, block_q=96,
                                      block_kv=128)),
    "gqa-4": (70, 150, 8, 2, dict(causal=False)),
    "rows-see-nothing": (32, 32, 2, 2, dict(q_offset=-8)),
}


def flash_limit(want):
    """fp32: 1e-4; bf16: 2 ulps at the output's largest magnitude."""
    if want.dtype == torch.float32:
        return 1e-4
    top = float(want.float().abs().max())
    return 2.0 * 2.0 ** (torch.tensor(top).log2().floor().item() - 7)


@pytest.mark.parametrize("mode", list(FLASH_MODES))
@pytest.mark.parametrize("D", [16, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain_version(card, mode, D, dtype):
    Sq, Skv, Hq, Hkv, kw = FLASH_MODES[mode]
    g = torch.Generator(device=card).manual_seed(Sq + D)
    q = torch.randn((2, Sq, Hq, D), generator=g, device=card).to(dtype)
    k = torch.randn((2, Skv, Hkv, D), generator=g, device=card).to(dtype)
    v = torch.randn((2, Skv, Hkv, D), generator=g, device=card).to(dtype)
    before = fops.flash_mha.launches, fops.flash_mha.launches_tc
    got = fops.flash_mha(q, k, v, n_kv_heads=Hkv, **kw)
    torch.cuda.synchronize()
    tc = int(fops.kernel_path(dtype, D) == "wgmma")
    assert (fops.flash_mha.launches,
            fops.flash_mha.launches_tc) == (before[0] + 1, before[1] + tc)
    want = fref.flash_mha_ref(q, k, v, n_kv_heads=Hkv,
                              **{**dict(block_q=128, block_kv=128), **kw})
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= flash_limit(want), (mode, D, dtype, err)
    if mode == "rows-see-nothing":
        assert float(got[:, :8].float().abs().max()) == 0.0


FLASH_TC_LENGTHS = [  # Sq, Skv, causal: across and short of 128-wide tiles
    (1, 1, False), (127, 129, False), (129, 255, False), (300, 77, False),
    (200, 1000, True), (257, 700, True), (300, 77, True)]


@pytest.mark.parametrize("lengths", FLASH_TC_LENGTHS,
                         ids=[f"{a}x{b}{'c' if c else ''}"
                              for a, b, c in FLASH_TC_LENGTHS])
@pytest.mark.parametrize("D", [96, 128])
def test_flash_tensor_core_kernel_at_ragged_lengths(card, lengths, D):
    Sq, Skv, causal = lengths
    g = torch.Generator(device=card).manual_seed(Sq * 7 + Skv + D)
    bf16 = torch.bfloat16
    q = torch.randn((2, Sq, 8, D), generator=g, device=card).to(bf16)
    k = torch.randn((2, Skv, 2, D), generator=g, device=card).to(bf16)
    v = torch.randn((2, Skv, 2, D), generator=g, device=card).to(bf16)
    kw = dict(causal=causal, q_offset=Skv - Sq if causal else 0)
    before = fops.flash_mha.launches_tc
    got = fops.flash_mha(q, k, v, n_kv_heads=2, **kw)
    torch.cuda.synchronize()
    assert fops.flash_mha.launches_tc == before + 1
    want = fref.flash_mha_ref(q, k, v, n_kv_heads=2, **kw)
    err = float((got.float() - want.float()).abs().max())
    assert err <= flash_limit(want), (lengths, D, err)
    if causal and Sq > Skv:                 # the first rows see nothing
        assert float(got[:, :Sq - Skv].float().abs().max()) == 0.0


def test_mha_dispatches_to_the_flash_kernel(card):
    g = torch.Generator(device=card).manual_seed(5)
    q = torch.randn((1, 96, 4, 16), generator=g, device=card)
    k = torch.randn((1, 269, 4, 16), generator=g, device=card)
    v = torch.randn((1, 269, 4, 16), generator=g, device=card)
    before = fops.flash_mha.launches
    out = mha(q, k, v, n_kv_heads=4, causal=False)
    assert fops.flash_mha.launches == before + 1
    torch.testing.assert_close(out, mha_plain(q, k, v, n_kv_heads=4,
                                              causal=False),
                               rtol=0, atol=1e-4)
    # a per-row mask keeps the plain masked segment: no launch
    mha(q, k, v, n_kv_heads=4, causal=False,
        kv_mask=torch.ones((1, 269), dtype=torch.bool, device=card))
    assert fops.flash_mha.launches == before + 1


def test_flash_kernel_rejects_what_it_cannot_run(card):
    g = torch.Generator(device=card).manual_seed(6)

    def qkv(D=16, dtype=torch.float32, S=128):
        return tuple(torch.randn((1, S, 2, D), generator=g,
                                 device=card).to(dtype) for _ in range(3))

    q, k, v = qkv(dtype=torch.float16)
    with pytest.raises(TypeError):
        fops.flash_mha(q, k, v, n_kv_heads=2)
    q, k, v = qkv()
    with pytest.raises(TypeError):
        fops.flash_mha(q, k.bfloat16(), v, n_kv_heads=2)
    q, k, v = qkv(D=48)
    with pytest.raises(ValueError, match="head dims"):
        fops.flash_mha(q, k, v, n_kv_heads=2)
    q, k, v = qkv(S=192)
    with pytest.raises(ValueError, match="divide"):
        fops.flash_mha(q, k, v, n_kv_heads=2, sparsity=0.7, block_q=128,
                       block_kv=128)
    with pytest.raises(ValueError, match="causal schedule"):
        fops.flash_mha(q, k, v, n_kv_heads=2, causal=False, sparsity=0.7,
                       block_q=64, block_kv=64)
    with pytest.raises(ValueError):
        fops.flash_mha(q, k.cpu(), v, n_kv_heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        fops.flash_mha(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                       v, n_kv_heads=2)


SSD_CASES = {  # B, S, H, P, N, chunk, init_state
    "mamba2-780m-ragged": (2, 300, 4, 64, 128, 128, False),
    "mamba2-780m-init": (1, 256, 3, 64, 128, 128, True),
    "mamba2-780m-short": (2, 57, 2, 64, 128, 128, True),
    "reduced-ragged": (2, 100, 8, 16, 16, 16, False),
    "reduced-init": (2, 48, 8, 16, 16, 16, True),
    "reduced-whole-chunks": (2, 64, 4, 16, 16, 16, False),
    "reduced-chunk32-ragged": (1, 100, 2, 16, 16, 32, False),
    "reduced-odd": (2, 33, 3, 16, 16, 8, True),
}


def ssd_inputs(dev, B, S, H, P, N, dtype, init, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g, device=dev).to(dtype)
    dt = F.softplus(torch.randn((B, S, H), generator=g, device=dev) - 1.0)
    A = -torch.exp(torch.randn((H,), generator=g, device=dev))
    Bm = torch.randn((B, S, 1, N), generator=g, device=dev).to(dtype)
    Cm = torch.randn((B, S, 1, N), generator=g, device=dev).to(dtype)
    s0 = torch.randn((B, H, P, N), generator=g, device=dev) if init \
        else None
    return x, dt, A, Bm, Cm, s0


def ssd_limit(want):
    """fp32: 1e-4 of the largest magnitude (at least 1e-4); bf16: 2
    ulps at the largest magnitude."""
    top = float(want.float().abs().max())
    if want.dtype == torch.float32:
        return 1e-4 * max(1.0, top)
    return 2.0 * 2.0 ** (torch.tensor(top).log2().floor().item() - 7)


def check_ssd(got, want):
    (y, f), (y0, f0) = got, want
    assert y.dtype == y0.dtype and y.shape == y0.shape
    assert f.dtype == torch.float32 and f.shape == f0.shape
    assert float((y.float() - y0.float()).abs().max()) <= ssd_limit(y0)
    assert float((f - f0).abs().max()) <= ssd_limit(f0)


@pytest.mark.parametrize("case", list(SSD_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_kernel_matches_plain_version(card, case, dtype):
    B, S, H, P, N, chunk, init = SSD_CASES[case]
    x, dt, A, Bm, Cm, s0 = ssd_inputs(card, B, S, H, P, N, dtype, init,
                                      seed=S + P)
    before = sops.ssd.launches
    got = sops.ssd(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    assert sops.ssd.launches == before + 1
    check_ssd(got, sref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                init_state=s0))


def test_ssd_kernel_reads_strided_views(card):
    """x, B and C as slices of one [B, S, H*P + 2N] tensor, as
    ``ssm.mamba_block`` passes the conv output."""
    B, S, H, P, N = 2, 200, 3, 64, 128
    g = torch.Generator(device=card).manual_seed(9)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g,
                      device=card).bfloat16()
    xi, Bp, Cp = torch.split(xbc, [H * P, N, N], dim=-1)
    x = xi.reshape(B, S, H, P)
    Bm, Cm = Bp.reshape(B, S, 1, N), Cp.reshape(B, S, 1, N)
    assert not x.is_contiguous()
    dt = F.softplus(torch.randn((B, S, H), generator=g, device=card))
    A = -torch.exp(torch.randn((H,), generator=g, device=card))
    check_ssd(sops.ssd(x, dt, A, Bm, Cm, chunk=128),
              sref.ssd_ref(x.contiguous(), dt, A, Bm.contiguous(),
                           Cm.contiguous(), chunk=128))


def test_ssd_kernel_rejects_what_it_cannot_run(card):
    def inputs(P=16, N=16, G=1, dtype=torch.float32, S=40):
        x, dt, A, Bm, Cm, _ = ssd_inputs(card, 2, S, 2, P, N, dtype, False,
                                         seed=1)
        return x, dt, A, Bm.repeat(1, 1, G, 1), Cm.repeat(1, 1, G, 1)

    with pytest.raises(ValueError, match="n_groups"):
        sops.ssd(*inputs(G=2), chunk=16)
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        sops.ssd(*inputs(P=32), chunk=16)
    with pytest.raises(ValueError, match="chunk length"):
        sops.ssd(*inputs(S=300), chunk=256)
    with pytest.raises(TypeError):
        sops.ssd(*inputs(dtype=torch.float16), chunk=16)
    x, dt, A, Bm, Cm = inputs()
    with pytest.raises(TypeError):
        sops.ssd(x, dt, A, Bm.bfloat16(), Cm, chunk=16)
    with pytest.raises(ValueError):
        sops.ssd(x, dt, A, Bm.cpu(), Cm, chunk=16)
    with pytest.raises(ValueError, match="init_state"):
        sops.ssd(x, dt, A, Bm, Cm, chunk=16,
                 init_state=torch.zeros((2, 2, 16, 8), device=card))
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        sops.ssd(*inputs(P=8, N=4), chunk=8)


# ---------------------------------------------------------------------------
# paged chunk attention on head-range views (elastic SP2 shards)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 70, 8, 4, 16, 77, 3),
                                   (2, 64, 12, 12, 128, 200, 3)],
                         ids=["reduced-gqa", "self-forcing"])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16", "fp8"])
def test_kernel_reads_a_head_range_view_in_place(card, shape, dtypes):
    B, Sq, Hq, Hkv, D, page, n = shape
    q, kp, vp, table, mask = _inputs(card, *shape, *dtypes, seed=D + Hkv)
    hint = dict(sink=page - 5, chunk_tokens=page - 11)
    h2 = Hkv // 2
    path = _path(q, kp)
    before = ops.paged_chunk_attention.launches_tc
    for lo, hi in ((0, h2), (h2, Hkv)):
        kv_view, vv_view = kp[..., lo:hi, :], vp[..., lo:hi, :]
        assert not kv_view.is_contiguous()
        qs = shard_heads(q, Hkv, lo, hi).contiguous()
        for m in (None, mask):
            got = ops.paged_chunk_attention(qs, kv_view, vv_view, table, m,
                                            **hint)
            copy = ops.paged_chunk_attention(qs, kv_view.contiguous(),
                                             vv_view.contiguous(), table,
                                             m, **hint)
            for g, c in zip(got, copy):
                assert torch.equal(g, c)
            _check(got, ref.paged_chunk_attention_ref(
                qs, kv_view, vv_view, table, m, **hint), path)
    torch.cuda.synchronize()
    assert ops.paged_chunk_attention.launches_tc == before + 8 * (
        path == "wgmma")
    with pytest.raises(ValueError, match="dense"):          # every 2nd head
        ops.paged_chunk_attention(shard_heads(q, Hkv, 0, h2).contiguous(),
                                  kp[:, :, ::2], vp[:, :, ::2], table, mask)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

DECODE_SHAPES = [  # B, Hq, Hkv, D, page, n, P_total
    (2, 4, 2, 16, 8, 4, 16),        # the reference tests' shapes
    (3, 8, 8, 32, 16, 3, 12),
    (1, 4, 1, 64, 8, 6, 8),
    (3, 12, 1, 128, 16, 5, 20),     # G = 12: two row groups of 8
    (4, 32, 8, 128, 16, 64, 300),   # minitron-8b's attention, 1k context
]


def _decode_inputs(dev, B, Hq, Hkv, D, page, n, P, dtype, seed,
                   kv_dtype=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    kv_dtype = kv_dtype or dtype
    cast = to_fp8_e4m3 if kv_dtype == torch.float8_e4m3fn else \
        (lambda t: t.to(kv_dtype))
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(dtype)
    kp = cast(torch.randn((P, page, Hkv, D), generator=g, device=dev))
    vp = cast(torch.randn((P, page, Hkv, D), generator=g, device=dev))
    table = torch.randint(0, P, (B, n), generator=g, device=dev,
                          dtype=torch.int32)
    lengths = torch.randint(1, n * page + 1, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[0] = n * page                        # a full table
    return q, kp, vp, table, lengths


def _decode_limit(want):
    if want.dtype == torch.float32:
        return 1e-5
    top = float(want.float().abs().max())
    return 2 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float8_e4m3fn),
    (torch.float32, torch.float8_e4m3fn),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)],
    ids=["f32", "bf16", "bf16-fp8", "f32-fp8", "bf16-f32", "f32-bf16"])
def test_decode_kernel_matches_plain_version(card, shape, dtype, kv_dtype):
    q, kp, vp, table, lengths = _decode_inputs(card, *shape, dtype,
                                               seed=sum(shape),
                                               kv_dtype=kv_dtype)
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(q, kp, vp, table, lengths)
    want = ref.paged_decode_attention_ref(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= _decode_limit(want), err


def test_decode_kernel_length_zero_and_unread_pages(card):
    """Length 0 gives 0 (the TPU kernel's l == 0 -> 1) where the plain
    version gives NaN (the oracle's); table entries of pages wholly past
    a stream's length are never read, even when they point nowhere."""
    B, Hq, Hkv, D, page, n, P = 3, 8, 2, 64, 16, 6, 20
    q, kp, vp, table, _ = _decode_inputs(card, B, Hq, Hkv, D, page, n, P,
                                         torch.float32, seed=3)
    lengths = torch.tensor([37, 0, 16], dtype=torch.int32, device=card)
    got = ops.paged_decode_attention(q, kp, vp, table, lengths)
    want = ref.paged_decode_attention_ref(q, kp, vp, table, lengths)
    assert (got[1] == 0).all() and torch.isnan(want[1]).all()
    live = torch.tensor([0, 2], device=card)
    assert float((got[live] - want[live]).abs().max()) <= 1e-5
    wild = table.clone()
    wild[0, 3:] = 1 << 30                       # past 37 tokens: unread
    wild[1, :] = -(1 << 30)
    wild[2, 1:] = 1 << 30
    again = ops.paged_decode_attention(q, kp, vp, wild, lengths)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


def test_decode_kernel_rejects_what_it_cannot_run(card):
    q, kp, vp, table, lengths = _decode_inputs(card, 2, 4, 2, 48, 8, 2, 4,
                                               torch.float32, seed=0)
    with pytest.raises(ValueError, match="head dims"):
        ops.paged_decode_attention(q, kp, vp, table, lengths)
    q, kp, vp, table, lengths = _decode_inputs(card, 2, 4, 2, 16, 8, 2, 4,
                                               torch.float32, seed=0)
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q.half(), kp, vp, table, lengths)
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q, kp, vp.bfloat16(), table, lengths)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, kp.cpu(), vp, table, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_decode_attention(q, kp[:, :, :1], vp[:, :, :1], table,
                                   lengths)


# ---------------------------------------------------------------------------
# scaled fp8 matmul
# ---------------------------------------------------------------------------

# the reference tests' shapes (tests/test_kernels.py), held element by
# element to the reference's own rtol = atol = 1e-5
FP8_REF_SHAPES = [(64, 64, 64), (128, 256, 64), (32, 32, 32)]   # M, K, N
FP8_SHAPES = FP8_REF_SHAPES + [(200, 136, 264), (130, 40, 24),
                               (1, 4096, 300), (257, 1536, 8960)]
FP8_REL = 1e-5
FP8_FFN_SHAPES = [(32768, 4096, 16384), (10560, 1536, 8960)]


def _fp8_gap(got, want):
    """max |got - want| over max |want| (fp32 outputs)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _fp8_check(got, want, path, elementwise=False):
    """|d| <= 1e-5 of max |want|, or, ``elementwise``, the reference's
    |d| <= 1e-5 + 1e-5 |want|; plus one bf16 ulp per element in bf16."""
    top = float(want.float().abs().max())
    d = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(1e-30)
        d = d - torch.exp2(torch.floor(torch.log2(mag)) - 7)
    if elementwise:
        tol = FP8_REL + FP8_REL * want.float().abs()
    else:
        tol = torch.full_like(d, FP8_REL * max(top, 1e-30))
    print(f"fp8 {path} {tuple(want.shape)} {want.dtype}: gap "
          f"{float(d.max()) / max(top, 1e-30):.3g} of max |out|, worst "
          f"|d| / limit {float((d / tol).max()):.3g}")
    assert bool((d <= tol).all()), (path, float((d - tol).max()))


@pytest.mark.parametrize("shape", FP8_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fp8_kernel_matches_plain_version(card, shape, out_dtype):
    M, K, N = shape
    g = torch.Generator(device=card).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=card)
    w = torch.randn((K, N), generator=g, device=card).bfloat16()
    xq, sx = f8ops.quantize_fp8(x, axis=1)
    wq, sw = f8ops.quantize_fp8(w, axis=0)
    path = f8ops.kernel_path(K, N)
    before = (f8ops.fp8_scaled_matmul.launches,
              f8ops.fp8_scaled_matmul.launches_tc)
    got = f8ops.fp8_scaled_matmul(xq, wq, sx, sw, out_dtype=out_dtype)
    want = f8ref.fp8_matmul_ref(xq, wq, sx, sw).to(out_dtype)
    torch.cuda.synchronize()
    assert (f8ops.fp8_scaled_matmul.launches,
            f8ops.fp8_scaled_matmul.launches_tc) == (
        before[0] + 1, before[1] + int(path == "wgmma"))
    assert got.shape == (M, N) and got.dtype == out_dtype
    at_ref = shape in FP8_REF_SHAPES
    _fp8_check(got, want, path, elementwise=at_ref)
    # the online-quantized entry point launches the same kernel
    _fp8_check(f8ops.fp8_matmul(x, w, out_dtype=out_dtype), want, path,
               elementwise=at_ref)


@pytest.mark.parametrize("shape", FP8_FFN_SHAPES,
                         ids=["minitron-8b", "ardit"])
def test_fp8_ffn_shapes_take_the_tensor_cores(card, shape):
    M, K, N = shape
    g = torch.Generator(device=card).manual_seed(K)
    x = torch.randn((M, K), generator=g, device=card, dtype=torch.bfloat16)
    w = torch.randn((K, N), generator=g, device=card,
                    dtype=torch.bfloat16) * 0.02
    before = f8ops.fp8_scaled_matmul.launches_tc
    got = f8ops.fp8_matmul(x, w)
    torch.cuda.synchronize()
    assert f8ops.fp8_scaled_matmul.launches_tc == before + 1
    xq, sx = f8ops.quantize_fp8(x, axis=1)
    wq, sw = f8ops.quantize_fp8(w, axis=0)
    _fp8_check(got, f8ref.fp8_matmul_ref(xq, wq, sx, sw), "wgmma")


def test_fp8_promotion_keeps_an_all_positive_sum_within_the_limit(card):
    # |randn| operands: every truncation of the tensor cores' fp32
    # accumulator errs the same way, the worst case for a long sum
    g = torch.Generator(device=card).manual_seed(4096)
    x = torch.randn((512, 4096), generator=g, device=card).abs()
    w = torch.randn((4096, 512), generator=g, device=card).abs()
    xq, sx = f8ops.quantize_fp8(x, axis=1)
    wq, sw = f8ops.quantize_fp8(w, axis=0)
    want = f8ref.fp8_matmul_ref(xq, wq, sx, sw)
    promoted = _fp8_gap(f8ops.fp8_scaled_matmul(xq, wq, sx, sw), want)
    print(f"fp8 all-positive K=4096: {promoted:.3g} of max |out|")
    assert promoted <= FP8_REL, promoted


def test_fp8_widening_is_exact_for_every_e4m3_value(card):
    """The tensor-core kernel widens e4m3 to bf16 in shared memory with
    integer arithmetic and one bf16 multiply: every one of the 256 codes
    (subnormals, both zeros, NaN) must come out equal to the plain
    version's, through either operand (a product with 1.0 and zeros)."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    one = torch.tensor(1.0).to(torch.float8_e4m3fn).view(torch.uint8)
    # x [256, 16]: code m in column 0; w [16, 16]: 1.0 in row 0
    x = torch.zeros((256, 16), dtype=torch.uint8)
    x[:, 0] = codes
    w = torch.zeros((16, 16), dtype=torch.uint8)
    w[0] = one
    for xq, wq in ((x, w), (w.t().contiguous(), x.t().contiguous())):
        xq = xq.view(torch.float8_e4m3fn).to(card)
        wq = wq.view(torch.float8_e4m3fn).to(card)
        sx = torch.ones((xq.shape[0], 1), device=card)
        sw = torch.ones((1, wq.shape[1]), device=card)
        assert f8ops.kernel_path(xq.shape[1], wq.shape[1]) == "wgmma"
        got = f8ops.fp8_scaled_matmul(xq, wq, sx, sw)
        want = f8ref.fp8_matmul_ref(xq, wq, sx, sw)
        nan = torch.isnan(want)
        assert int(nan.sum()) == 2 * 16        # the two NaN codes
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan], want[~nan])


def test_quantize_on_the_card_matches_the_cpu(card):
    g = torch.Generator().manual_seed(5)
    x = torch.randn((33, 70), generator=g)
    x[1] = 0.0
    x[2] *= 1e4
    x[3, 5] = float("inf")
    for axis in (0, 1):
        for t in (x, x.bfloat16()):
            qc, sc = f8ops.quantize_fp8(t, axis)
            qg, sg = f8ops.quantize_fp8(t.to(card), axis)
            assert torch.equal(sg.cpu(), sc)
            nan = torch.isnan(qc.float())
            assert torch.equal(torch.isnan(qg.float()).cpu(), nan)
            assert torch.equal(qg.cpu().view(torch.uint8)[~nan],
                               qc.view(torch.uint8)[~nan])


def test_fp8_kernel_rejects_what_it_cannot_run(card):
    x = torch.randn((16, 32), device=card)
    xq, sx = f8ops.quantize_fp8(x, axis=1)
    wq, sw = f8ops.quantize_fp8(torch.randn((32, 16), device=card), axis=0)
    with pytest.raises(TypeError):
        f8ops.fp8_scaled_matmul(x, wq, sx, sw)
    with pytest.raises(ValueError, match="shapes"):
        f8ops.fp8_scaled_matmul(xq, wq[:16], sx, sw)
    with pytest.raises(TypeError):
        f8ops.fp8_scaled_matmul(xq, wq, sx, sw, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        f8ops.fp8_scaled_matmul(xq, wq.cpu(), sx, sw)


# ---------------------------------------------------------------------------
# the tensor-core paths of the decode and SSD kernels
# ---------------------------------------------------------------------------

DECODE_TC_EDGES = {  # B, Hq, Hkv, D, page, n, P_total, lengths, page dtype
    "one past a unit boundary": (2, 32, 8, 128, 16, 256, 600, (257, 513),
                                 torch.bfloat16),
    "one stream of 32768": (1, 32, 8, 128, 16, 2048, 4096, (32768,),
                            torch.bfloat16),
    "lengths 0 and 1": (4, 8, 2, 128, 16, 4, 20, (0, 1, 0, 37),
                        torch.float8_e4m3fn),
    "D 64, pages of 8, G 8": (3, 16, 2, 64, 8, 40, 130, (320, 9, 161),
                              torch.bfloat16),
    "D 64, e4m3 pages of 64": (3, 8, 8, 64, 64, 6, 20, (384, 65, 3),
                               torch.float8_e4m3fn),
}


@pytest.mark.parametrize("case", list(DECODE_TC_EDGES))
def test_decode_tensor_core_split_edges(card, case):
    B, Hq, Hkv, D, page, n, P, lengths, kv_dtype = DECODE_TC_EDGES[case]
    q, kp, vp, table, _ = _decode_inputs(card, B, Hq, Hkv, D, page, n, P,
                                         torch.bfloat16, seed=len(case),
                                         kv_dtype=kv_dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=card)
    assert ops.decode_kernel_path(q.dtype, kp.dtype, D, Hq // Hkv,
                                  page) == "mma"
    before = ops.paged_decode_attention.launches_tc
    got = ops.paged_decode_attention(q, kp, vp, table, ln)
    want = ref.paged_decode_attention_ref(q, kp, vp, table, ln)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches_tc == before + 1
    live = ln > 0
    assert (got[~live] == 0).all()
    err = float((got[live].float() - want[live].float()).abs().max())
    assert err <= _decode_limit(want[live]), err


@pytest.mark.parametrize("shape", [
    (2, 4, 2, 32, 16, 4, 16),       # D 32
    (3, 12, 1, 128, 16, 5, 20),     # a group of 12
    (2, 8, 2, 128, 24, 4, 16),      # pages of 24
], ids=["D32", "G12", "page24"])
def test_decode_outside_the_tensor_core_path_takes_the_cuda_cores(card,
                                                                  shape):
    q, kp, vp, table, lengths = _decode_inputs(card, *shape, torch.bfloat16,
                                               seed=4)
    B, Hq, Hkv, D, page = shape[:5]
    assert ops.decode_kernel_path(q.dtype, kp.dtype, D, Hq // Hkv,
                                  page) == "cuda_cores"
    before = (ops.paged_decode_attention.launches,
              ops.paged_decode_attention.launches_tc)
    got = ops.paged_decode_attention(q, kp, vp, table, lengths)
    want = ref.paged_decode_attention_ref(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert (ops.paged_decode_attention.launches,
            ops.paged_decode_attention.launches_tc) == (before[0] + 1,
                                                        before[1])
    assert float((got.float() - want.float()).abs().max()) <= \
        _decode_limit(want)


SSD_TC_CASES = {  # B, S, H, chunk, init_state, strided views
    "chained grid, 1,248 blocks": (2, 13243, 48, 128, True, True),
    "init_state and strided views": (2, 1000, 12, 128, True, True),
    "partial head group, chunk 64": (2, 1000, 7, 64, False, True),
    "S < chunk": (1, 100, 6, 128, True, False),
}


def _ssd_views(dev, B, S, H, init, view, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    P, N = 64, 128
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g,
                      device=dev).bfloat16()
    xi, Bp, Cp = torch.split(xbc, [H * P, N, N], dim=-1)
    x, Bm, Cm = xi.reshape(B, S, H, P), Bp.reshape(B, S, 1, N), \
        Cp.reshape(B, S, 1, N)
    if not view:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = F.softplus(torch.randn((B, S, H), generator=g, device=dev) - 3.0)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    s0 = torch.randn((B, H, P, N), generator=g, device=dev) if init \
        else None
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("case", list(SSD_TC_CASES))
def test_ssd_tensor_core_kernel(card, case):
    B, S, H, chunk, init, view = SSD_TC_CASES[case]
    x, dt, A, Bm, Cm, s0 = _ssd_views(card, B, S, H, init, view, seed=S)
    before = sops.ssd.launches_tc
    got = sops.ssd(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    assert sops.ssd.launches_tc == before + 1
    check_ssd(got, sref.ssd_ref(x.contiguous(), dt, A, Bm.contiguous(),
                                Cm.contiguous(), chunk=chunk,
                                init_state=s0))


def test_ssd_view_tma_cannot_read_takes_the_cuda_cores(card):
    """x/B/C sliced from a tensor whose rows are one element longer: the
    token stride is not a multiple of 8 elements, so ``kernel_path``
    names the CUDA-core kernel, which takes it (no launch on the tensor
    cores, the same answer)."""
    B, S, H, P, N = 2, 300, 4, 64, 128
    g = torch.Generator(device=card).manual_seed(3)
    wide = torch.randn((B, S, H * P + 2 * N + 1), generator=g,
                       device=card).bfloat16()
    xi, Bp, Cp, _ = torch.split(wide, [H * P, N, N, 1], dim=-1)
    x, Bm, Cm = xi.reshape(B, S, H, P), Bp.reshape(B, S, 1, N), \
        Cp.reshape(B, S, 1, N)
    assert sops.kernel_path(x.dtype, P, N,
                            sops._tma_aligned(x, Bm, Cm)) == "cuda_cores"
    dt = F.softplus(torch.randn((B, S, H), generator=g, device=card) - 3.0)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=card)
    before = (sops.ssd.launches, sops.ssd.launches_tc)
    got = sops.ssd(x, dt, A, Bm, Cm, chunk=128)
    torch.cuda.synchronize()
    assert (sops.ssd.launches, sops.ssd.launches_tc) == (before[0] + 1,
                                                         before[1])
    check_ssd(got, sref.ssd_ref(x.contiguous(), dt, A, Bm.contiguous(),
                                Cm.contiguous(), chunk=128))


def test_decode_tensor_core_path_never_reads_pages_past_the_length(card):
    """Table entries of pages wholly past a stream's length may point
    anywhere (even out of the pool) on the tensor-core path too: they
    are neither staged nor read, and the output does not change."""
    B, Hq, Hkv, D, page, n, P = 3, 8, 2, 128, 16, 40, 130
    q, kp, vp, table, _ = _decode_inputs(card, B, Hq, Hkv, D, page, n, P,
                                         torch.bfloat16, seed=8)
    lengths = torch.tensor([37, 0, 300], dtype=torch.int32, device=card)
    got = ops.paged_decode_attention(q, kp, vp, table, lengths)
    wild = table.clone()
    wild[0, 3:] = 1 << 30
    wild[1, :] = -(1 << 30)
    wild[2, 19:] = 1 << 30
    before = ops.paged_decode_attention.launches_tc
    again = ops.paged_decode_attention(q, kp, vp, wild, lengths)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches_tc == before + 1
    assert torch.equal(again, got) and (got[1] == 0).all()
