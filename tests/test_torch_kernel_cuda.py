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
that sees nothing, the main path's 2,640-token pages with a 77-token
sink, and ``ardit-causal-forcing``'s full-width chunk (2,640 queries,
16 heads of 96); every launch is checked to take the path ``kernel_path`` names
(``launches_tc``).  bf16 pages at D 96 take the persistent D 96 instance
(``chunk_instance``, counted in ``launches_d96``): at GQA 1, 2 and 4, on
the main path's pages with a context cut into parts, masked and not,
with and without the hint; an 8-head view of a 16-head pool gives the
full launch's rows bit for bit, and two calls give the same bits.  Tolerance: both accumulate in fp32 — m within 1e-4,
l within 1e-4 relative; the finalized acc / l within 1e-4 on the
CUDA-core kernel (summation order only) and within 2 bf16 ulps at its
largest magnitude on the tensor-core kernel (bf16 queries over bf16 or
e4m3 pages at D 96 / 128), which rounds P to bf16 before P V, as SDPA
and the flash kernel do; rows that see nothing are exactly (NEG_INF, 0,
0).

Flash attention: ``flash_mha`` against ``flash_mha_ref`` over head dims
16/64/96/128 x fp32/bf16 x each mode (non-causal at ragged AR-DiT-like
lengths, causal with ``q_offset``, sink + window, the rho keep matrix at
blocks that are not the kernels' tiles, GQA 4, causal GQA 2 at
granite-moe's 16 / 8 heads, rows that see nothing), the
tensor-core kernel (bf16 at D 64, 96 and 128) at lengths that cross and
miss its 128-row and 128-key tiles (whisper-medium's 1,500 encoder
frames and its one-row decode cross-attention among them), ``mha``'s
dispatch, and the inputs
the wrapper refuses; every launch is checked to take the path
``kernel_path`` names.  Tolerance: 1e-4 for fp32 outputs; 2 bf16 ulps at
the output's largest magnitude for bf16 outputs (the CUDA-core kernel
rounds the same fp32 result once; the tensor-core kernel also rounds P
to bf16 before P V, as SDPA does, and stays within the same limit).

Flash attention's backward (``flash_mha_bwd``) against
``flash_mha_bwd_ref`` on the same q, k, v, output, log-sum-exp and
output gradient from the forward kernel, over the same modes, head dims
and dtypes: bf16 at D 64 / 96 / 128 on the tensor cores
(``csrc/flash_mha_bwd_wgmma.cu``, counted in ``launches_bwd_tc``) against
the plain version that rounds P and dS to bf16 as it does
(``round_bf16=True``), the rest on the CUDA cores
(``csrc/flash_mha_bwd.cu``) against the unrounded one, which also holds
the CUDA-core kernel when asked for at bf16 D 128; two calls bit for bit,
the forward's lse within 2e-4 of the plain version's; ``flash_mha`` under
grad (``FlashMHA``: a ``grad_fn``, one backward launch, on the tensor
cores for bf16 at D 64 and 128); the SSD, fp8 and paged wrappers raising
under grad; a reduced config's training gradients on the card against
the CPU's.  Tolerance: fp32 gradients within 1e-4 of each gradient's
largest magnitude, bf16 ones within 4 bf16 ulps at it (each side rounds
one fp32 sum, in another order); 1e-4 of each leaf's largest magnitude
for the training gradients.

Paged chunk attention on head-range views ``pool[..., lo:hi, :]`` (the
elastic SP2 shards): the kernel reads the view in place and gives
exactly the partials it gives on a contiguous copy of the view, and the
plain version's within the limits above.

Kernel 3's seeded form (``flash_mha_seeded``, ``paged_mha``'s in-chunk
segment on the card): ``paged_mha`` against kernel 1's same partials
finished by the plain version (``flash_mha_seeded_ref``) at the cell's
shape (4,680 queries over their own 4,680 keys, 12 heads of 128, bf16
pages, 1-4 rows), at ardit-causal-forcing's 16 heads of 96, at lengths
that are not multiples of 128 with GQA and a page mask, with a row whose
mask hides every context token (it equals non-causal attention over its
chunk alone) and on elastic SP2's head-range views of the pools and of
the chunk's k / v (the full call's heads bit for bit); one seeded launch
a call (``launches_seeded``), two calls bit for bit; fp32 and D 64 keep
the plain path (``flash_mha.plain_segments``), and the op refuses what
it cannot read.  Tolerance: kernel 1's, 2 bf16 ulps at the output's
largest magnitude (P enters P V in bf16).

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
instantiates (jamba-v0.1-52b's (64, 16) among them) x fp32/bf16 x/B/C,
ragged S, S < chunk, ``init_state``,
x/B/C as strided views of one wider tensor (as the model passes them),
and the inputs the wrapper refuses; bf16 at (64, 128) and at
jamba-v0.1-52b's (64, 16) takes the tensor-core kernels
(``launches_tc``), including a chained grid of many more blocks than are
resident, ``init_state`` with strided views and a partial head group; at
(64, 16) also against ``ssd_kernel_emulation`` (the kernel's own
factoring and rounding) and two calls bit for bit; a view TMA cannot
read takes the CUDA-core kernel by ``kernel_path``, and ``path=
"cuda_cores"`` takes it where the tensor cores would run.  Tolerance: y within 1e-4 of the
output's largest magnitude (at least 1e-4 absolute) in fp32, within 2
bf16 ulps at that magnitude in bf16; the fp32 final state within 1e-4
of its largest magnitude.  A scan's outputs grow with its inputs (unlike
attention's averages), so the fp32 limit is relative to them; both sides
accumulate in fp32 and differ in summation order only.

The reduced dense, MoE, VLM, hybrid and encoder-decoder configs (fp32,
TF32 off) on the card against the same params and inputs on the CPU:
prefill logits and cache, then three decode steps, within 1e-4.

The step cache's two device functions on the card against the same
functions on the CPU: the hit AXPY ``x - dt * v`` (one multiply-add per
element on both) and the recorded velocity bit for bit, the fp32 KV
signature (a mean over 1e7 values) and the delta within 1e-5 relative
(order of summation only).
"""
import math

import pytest

pytest.importorskip("torch")

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.fp8_matmul import ops as f8ops
from repro_torch.kernels.fp8_matmul import ref as f8ref
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.models.attention import mha, mha_plain, shard_heads
from repro_torch.models.attention import merge_head_shards, paged_mha
from repro_torch.models import stepcache
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
    (2, 80, 8, 4, 96, 150, 3),      # GQA 2 at D 96
    (3, 70, 16, 4, 96, 120, 4),     # GQA 4 at D 96, ragged row tile
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
    d96 = ops.chunk_instance(q.dtype, kp.dtype, D, Hq // Hkv) == "wgmma96"
    before = (ops.paged_chunk_attention.launches,
              ops.paged_chunk_attention.launches_tc,
              ops.paged_chunk_attention.launches_d96)
    for m, hint in ((None, dict(sink=sink, chunk_tokens=tc)),
                    (mask, {}),
                    (mask, dict(sink=sink, chunk_tokens=tc))):
        _check(ops.paged_chunk_attention(q, kp, vp, table, m, **hint),
               ref.paged_chunk_attention_ref(q, kp, vp, table, m, **hint),
               path)
    torch.cuda.synchronize()
    assert (ops.paged_chunk_attention.launches,
            ops.paged_chunk_attention.launches_tc,
            ops.paged_chunk_attention.launches_d96) == (
        before[0] + 3, before[1] + 3 * (path == "wgmma"), before[2] + 3 * d96)


@pytest.mark.parametrize("kv_dtype,D,n", [
    (torch.bfloat16, 128, 3), (torch.float8_e4m3fn, 128, 3),
    (torch.bfloat16, 96, 8)], ids=["bf16", "fp8", "bf16-d96"])
def test_kernel_at_the_main_paths_page(card, kv_dtype, D, n):
    """The main path's geometry: 2,640-token pages (20 full 128-token
    tiles and one of 80) behind a 77-token sink (one masked tile), all
    visible and with a token mask that drops 128-token runs; at D 96 on
    the D 96 instance, 7 ring pages (148 key tiles: a context cut into
    two parts), with and without the hint, and a fully-masked page, a
    hole row and a row that sees nothing."""
    B, Sq, H, page, sink = (1, 200, 2, 2640, 77) if D == 128 else \
        (3, 150, 2, 2640, 77)
    q, kp, vp, table, _ = _inputs(card, B, Sq, H, H, D, page, n,
                                  torch.bfloat16, kv_dtype, seed=2640)
    hint = dict(sink=sink, chunk_tokens=page)
    mask = torch.zeros((B, n, page), dtype=torch.bool, device=card)
    mask[:, 0, :sink] = True
    mask[:, 1:] = True
    mask[:, 1, 128:384] = False
    mask[:, 2, 1000:1100] = False
    cases = [(None, hint), (mask.view(B, n * page), hint)]
    if D == 96:
        assert len(ops.chunk_parts(n, page, **hint)) == 2
        mask[0, 3] = False                         # a fully-masked page
        table[1, -1] = table[1, 0]                 # a hole row ...
        mask[1, -1] = False                        # ... that never shows
        mask[2] = False                            # a row seeing nothing
        cases.append((mask.view(B, n * page), {}))
    before = (ops.paged_chunk_attention.launches_tc,
              ops.paged_chunk_attention.launches_d96)
    for m, h in cases:
        _check(ops.paged_chunk_attention(q, kp, vp, table, m, **h),
               ref.paged_chunk_attention_ref(q, kp, vp, table, m, **h),
               "wgmma")
    torch.cuda.synchronize()
    assert (ops.paged_chunk_attention.launches_tc,
            ops.paged_chunk_attention.launches_d96) == (
        before[0] + len(cases), before[1] + len(cases) * (D == 96))


@pytest.mark.parametrize("masked", [False, True], ids=["hint", "masked"])
def test_d96_instance_views_and_repeats_bit_for_bit(card, masked):
    """The D 96 instance's rows depend on their own inputs alone: an
    8-head view (offset 0 and 8) of a 16-head pool gives the full
    launch's rows bit for bit, and a second call the first's bits; both
    agree with the plain version.  A context of 8 table entries of 700
    tokens behind a 77-token sink is cut into parts."""
    B, Sq, H, D, page, n, sink = 2, 130, 16, 96, 700, 24, 77
    q, kp, vp, table, mask = _inputs(card, B, Sq, H, H, D, page, n,
                                     torch.bfloat16, torch.bfloat16,
                                     seed=96)
    hint = dict(sink=sink, chunk_tokens=page)
    assert len(ops.chunk_parts(n, page, **hint)) > 1
    m = mask if masked else None
    full = ops.paged_chunk_attention(q, kp, vp, table, m, **hint)
    again = ops.paged_chunk_attention(q, kp, vp, table, m, **hint)
    assert all(torch.equal(a, b) for a, b in zip(full, again))
    for lo in (0, 8):
        half = ops.paged_chunk_attention(
            q[:, :, lo:lo + 8].contiguous(), kp[:, :, lo:lo + 8],
            vp[:, :, lo:lo + 8], table, m, **hint)
        assert all(torch.equal(h, f[:, lo:lo + 8])
                   for h, f in zip(half, full))
    _check(full, ref.paged_chunk_attention_ref(q, kp, vp, table, m, **hint),
           "wgmma")


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
    "gqa-2-causal": (384, 384, 16, 8, dict()),
    "rows-see-nothing": (32, 32, 2, 2, dict(q_offset=-8)),
}


def flash_limit(want):
    """fp32: 1e-4; bf16: 2 ulps at the output's largest magnitude."""
    if want.dtype == torch.float32:
        return 1e-4
    top = float(want.float().abs().max())
    return 2.0 * 2.0 ** (torch.tensor(top).log2().floor().item() - 7)


@pytest.mark.parametrize("mode", list(FLASH_MODES))
@pytest.mark.parametrize("D", [16, 64, 96, 128])
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
    (200, 1000, True), (257, 700, True), (300, 77, True),
    # whisper-medium's encoder (1500 frames) and decode-step cross-attention
    (1500, 1500, False), (1, 1500, False)]


@pytest.mark.parametrize("lengths", FLASH_TC_LENGTHS,
                         ids=[f"{a}x{b}{'c' if c else ''}"
                              for a, b, c in FLASH_TC_LENGTHS])
@pytest.mark.parametrize("D", [64, 96, 128])
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


# the D 64 tensor-core kernel (persistent blocks of 192 queries) in every
# mode the wrapper takes: name -> (B, Sq, Skv, Hq, Hkv, keyword args)
FLASH_D64_MODES = {
    "non-causal-1500x1500": (2, 1500, 1500, 4, 4, dict(causal=False)),
    "non-causal-sq1": (2, 1, 1500, 4, 4, dict(causal=False)),
    "non-causal-193x77": (1, 193, 77, 2, 2, dict(causal=False)),
    "causal-gqa4-q-offset": (2, 768, 1536, 8, 2, dict(q_offset=700)),
    "causal-1152": (1, 1152, 1152, 4, 4, dict()),
    "sink-window": (1, 1024, 1024, 4, 4, dict(window=256, sink=77)),
    "sink-window-skipped-tiles": (1, 64, 1500, 2, 2,
                                  dict(window=100, sink=16, q_offset=1436)),
    "rho": (1, 1920, 1920, 4, 4, dict(sparsity=0.7, block_q=96,
                                      block_kv=160)),
    "rows-see-nothing": (2, 32, 32, 2, 2, dict(q_offset=-8)),
    # more items than SMs: each block walks several, rings and Q buffers
    # wrap around
    "many-items": (2, 3000, 700, 16, 16, dict(causal=False)),
}


@pytest.mark.parametrize("mode", list(FLASH_D64_MODES))
def test_flash_d64_kernel_matches_plain_version(card, mode):
    """At D 64 in bf16: the output within 2 bf16 ulps of the plain
    version's, the lse (the forward the backward reads) within 2e-4 of
    the plain version's and -inf exactly where it is, two calls bit for
    bit, each one launch on the tensor cores."""
    B, Sq, Skv, Hq, Hkv, kw = FLASH_D64_MODES[mode]
    g = torch.Generator(device=card).manual_seed(Sq + 64)
    q = torch.randn((B, Sq, Hq, 64), generator=g, device=card).bfloat16()
    k = torch.randn((B, Skv, Hkv, 64), generator=g, device=card).bfloat16()
    v = torch.randn((B, Skv, Hkv, 64), generator=g, device=card).bfloat16()
    m = _bwd_mode(Sq, Skv, Hkv, kw)
    assert fops.kernel_path(torch.bfloat16, 64) == "wgmma"
    before = fops.flash_mha.launches, fops.flash_mha.launches_tc
    out, lse = fops._launch(q, k, v, Hkv, m["causal"], m["q_offset"],
                            m["window"], m["sink"], m["sparsity"],
                            m["block_q"], m["block_kv"], with_lse=True)
    again = fops.flash_mha(q, k, v, **m)
    torch.cuda.synchronize()
    assert (fops.flash_mha.launches,
            fops.flash_mha.launches_tc) == (before[0] + 2, before[1] + 2)
    want, lse0 = fref.flash_mha_ref(q, k, v, return_lse=True, **m)
    err = float((out.float() - want.float()).abs().max())
    assert err <= flash_limit(want), (mode, err)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse0))
    fin = torch.isfinite(lse0)
    if fin.any():
        assert float((lse - lse0)[fin].abs().max()) <= 2e-4
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))
    if mode == "rows-see-nothing":
        assert float(out[:, :8].float().abs().max()) == 0.0


# the D 128 causal instance (persistent blocks of 128 queries, causal
# without window, sink or rho) at every edge of its mode: name -> (B, Sq,
# Skv, Hq, Hkv, keyword args)
FLASH_D128_CAUSAL_MODES = {
    "gqa4-1024": (2, 1024, 1024, 8, 2, dict()),
    # (a ragged Sq is one block of the plain version's causal schedule)
    "gqa6-q-offset-partial-tiles": (1, 700, 1000, 12, 2,
                                    dict(q_offset=300, block_q=700)),
    # item 0 sees nothing (its slot is -1), item 1 one tile
    "negative-q-offset": (1, 300, 200, 4, 1, dict(q_offset=-150,
                                                  block_q=300)),
    "sq1-q-offset": (2, 1, 1500, 8, 2, dict(q_offset=1499)),
    "ragged-777-gqa1": (1, 777, 777, 6, 6, dict(block_q=777)),
    # 2,048 items on 132 blocks: rings and Q buffers wrap around
    "more-items-than-sms": (2, 4096, 4096, 32, 8, dict()),
}


@pytest.mark.parametrize("mode", list(FLASH_D128_CAUSAL_MODES))
def test_flash_d128_causal_instance_matches_plain_version(card, mode):
    """At D 128 causal in bf16: one launch of the causal instance a call,
    the output within 2 bf16 ulps of the plain version's and within 8 of
    SDPA's (an explicit causal mask at q_offset; rows that see nothing
    left out, where SDPA gives NaN), the lse within 2e-4 of the plain
    version's and -inf exactly where it is, two calls bit for bit."""
    B, Sq, Skv, Hq, Hkv, kw = FLASH_D128_CAUSAL_MODES[mode]
    g = torch.Generator(device=card).manual_seed(Sq + 128)
    q = torch.randn((B, Sq, Hq, 128), generator=g, device=card).bfloat16()
    k = torch.randn((B, Skv, Hkv, 128), generator=g, device=card).bfloat16()
    v = torch.randn((B, Skv, Hkv, 128), generator=g, device=card).bfloat16()
    m = _bwd_mode(Sq, Skv, Hkv, kw)
    assert fops.fwd_instance(torch.bfloat16, 128, m["causal"], m["window"],
                             m["sink"], m["sparsity"]) == "wgmma128_causal"
    fm = fops.flash_mha
    before = fm.launches, fm.launches_tc, fm.launches_d128_causal
    out, lse = fops._launch(q, k, v, Hkv, m["causal"], m["q_offset"],
                            m["window"], m["sink"], m["sparsity"],
                            m["block_q"], m["block_kv"], with_lse=True)
    again = fops.flash_mha(q, k, v, **m)
    torch.cuda.synchronize()
    assert (fm.launches, fm.launches_tc, fm.launches_d128_causal) == tuple(
        n + 2 for n in before)
    want, lse0 = fref.flash_mha_ref(q, k, v, return_lse=True, **m)
    err = float((out.float() - want.float()).abs().max())
    assert err <= flash_limit(want), (mode, err)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse0))
    fin = torch.isfinite(lse0)
    if fin.any():
        assert float((lse - lse0)[fin].abs().max()) <= 2e-4
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))
    pos = torch.arange(Sq, device=card)[:, None] + m["q_offset"]
    mask = torch.arange(Skv, device=card)[None, :] <= pos
    rows = mask.any(dim=1)
    if not rows.all():                  # rows that see nothing give 0
        assert float(out[:, ~rows].float().abs().max()) == 0.0
    lib = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(Hq // Hkv, 1),
        v.transpose(1, 2).repeat_interleave(Hq // Hkv, 1),
        attn_mask=mask).transpose(1, 2)
    top = float(out[:, rows].float().abs().max())
    lib_err = float((out[:, rows].float() - lib[:, rows].float()).abs().max())
    assert lib_err <= 8 * 2.0 ** (math.floor(math.log2(top)) - 7), (mode,
                                                                    lib_err)


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
    "jamba-ragged": (2, 300, 4, 64, 16, 128, False),
    "jamba-init": (1, 256, 3, 64, 16, 128, True),
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


SSD_TC_CASES = {  # B, S, H, N, chunk, init_state, strided views
    "chained grid, 1,248 blocks": (2, 13243, 48, 128, 128, True, True),
    "init_state and strided views": (2, 1000, 12, 128, 128, True, True),
    "partial head group, chunk 64": (2, 1000, 7, 128, 64, False, True),
    "S < chunk": (1, 100, 6, 128, 128, True, False),
    # jamba-v0.1-52b's state width, (P, N) = (64, 16)
    "N 16 chained grid": (2, 13243, 48, 16, 128, True, True),
    "N 16 init_state and strided views": (2, 1000, 12, 16, 128, True, True),
    "N 16 ragged, contiguous": (2, 300, 8, 16, 128, False, False),
    "N 16 partial head group, chunk 64": (2, 1000, 7, 16, 64, False, True),
    "N 16 H not a multiple of the group": (1, 515, 10, 16, 128, True,
                                           False),
    "N 16 S < chunk": (1, 100, 6, 16, 128, True, False),
}


def _ssd_views(dev, B, S, H, init, view, seed, N=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    P = 64
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
    """bf16 at (64, 128) and (64, 16) on the tensor cores: one
    tensor-core launch, within the limits of ``ssd_ref`` and of
    ``ssd_kernel_emulation`` (the kernel's own factoring and rounding),
    and a second call equal bit for bit (no atomics on the data)."""
    B, S, H, N, chunk, init, view = SSD_TC_CASES[case]
    x, dt, A, Bm, Cm, s0 = _ssd_views(card, B, S, H, init, view, seed=S,
                                      N=N)
    assert sops.kernel_path(x.dtype, 64, N,
                            sops._tma_aligned(x, Bm, Cm)) == "wgmma"
    before = (sops.ssd.launches, sops.ssd.launches_tc)
    got = sops.ssd(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    assert (sops.ssd.launches, sops.ssd.launches_tc) == (before[0] + 1,
                                                         before[1] + 1)
    args = (x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous())
    check_ssd(got, sref.ssd_ref(*args, chunk=chunk, init_state=s0))
    check_ssd(got, sref.ssd_kernel_emulation(*args, chunk=chunk,
                                             init_state=s0))
    again = sops.ssd(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_ssd_cuda_core_passes_on_request_at_jamba_state(card):
    """``path="cuda_cores"`` runs the three CUDA-core passes on views the
    tensor cores would take (no tensor-core launch, the same answer);
    ``path="wgmma"`` where the tensor cores cannot run raises."""
    x, dt, A, Bm, Cm, s0 = _ssd_views(card, 2, 300, 8, True, True, seed=5,
                                      N=16)
    before = (sops.ssd.launches, sops.ssd.launches_tc)
    got = sops.ssd(x, dt, A, Bm, Cm, chunk=128, init_state=s0,
                   path="cuda_cores")
    torch.cuda.synchronize()
    assert (sops.ssd.launches, sops.ssd.launches_tc) == (before[0] + 1,
                                                         before[1])
    check_ssd(got, sref.ssd_ref(x.contiguous(), dt, A, Bm.contiguous(),
                                Cm.contiguous(), chunk=128, init_state=s0))
    with pytest.raises(ValueError, match="no 'wgmma' kernel"):
        sops.ssd(x.float(), dt, A, Bm.float(), Cm.float(), chunk=128,
                 path="wgmma")


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


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn],
                         ids=["bf16", "fp8"])
def test_kernel_at_causal_forcings_full_width(card, kv_dtype):
    """``ardit-causal-forcing``'s chunk at full width: 2,640 queries, 16
    heads of 96 (two 64-column TMA boxes, the second half zero-filled),
    over a 77-token sink and two 2,640-token pages, on the tensor
    cores."""
    B, Sq, H, D, page, n, sink = 1, 2640, 16, 96, 2640, 3, 77
    q, kp, vp, table, _ = _inputs(card, B, Sq, H, H, D, page, n,
                                  torch.bfloat16, kv_dtype, seed=96)
    hint = dict(sink=sink, chunk_tokens=page)
    assert _path(q, kp) == "wgmma"
    before = ops.paged_chunk_attention.launches_tc
    _check(ops.paged_chunk_attention(q, kp, vp, table, None, **hint),
           ref.paged_chunk_attention_ref(q, kp, vp, table, None, **hint),
           "wgmma")
    torch.cuda.synchronize()
    assert ops.paged_chunk_attention.launches_tc == before + 1


@pytest.mark.parametrize("steps", [2, 3, 4])
def test_step_cache_on_the_card_matches_the_cpu(card, steps):
    dt = 1.0 / steps
    g = torch.Generator().manual_seed(steps)
    x = torch.randn((1, 2640, 16), generator=g)
    x_new = torch.randn((1, 2640, 16), generator=g)
    k = torch.randn((30, 2640, 12, 128), generator=g)
    pools = {}
    for dev in ("cpu", card):
        v = torch.randn((3, 1, 2640, 16),
                        generator=torch.Generator().manual_seed(7)).to(dev)
        f = torch.zeros((3, 30), device=dev)
        delta = stepcache._record(v, f, 1, x.to(dev), x_new.to(dev),
                                  torch.full((), dt, device=dev),
                                  k.to(dev))
        hit = stepcache._apply_cached(x.to(dev), v, 1, dt)
        pools[str(dev)] = (v.cpu(), f.cpu(), float(delta), hit.cpu())
    (v0, f0, d0, h0), (v1, f1, d1, h1) = pools["cpu"], pools[str(card)]
    assert torch.equal(v1, v0)
    assert torch.equal(h1, h0) and h1.dtype == torch.float32
    torch.testing.assert_close(f1, f0, rtol=1e-5, atol=0)
    assert d1 == pytest.approx(d0, rel=1e-5)


FAMILY_ARCHS = ["minitron-8b", "granite-moe-1b-a400m", "internvl2-26b",
                "jamba-v0.1-52b", "whisper-medium"]


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _snapshot(tree):
    """A CPU copy (decode writes its cache in place)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _tree_close(got, want, limit):
    if isinstance(want, dict):
        for k in want:
            _tree_close(got[k], want[k], limit)
    else:
        assert float((got.cpu().float() - want.float()).abs().max()) \
            <= limit


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reduced_families_on_the_card_match_the_cpu(card, arch):
    """Prefill (the flash and SSD kernels on the card, their plain
    versions on the CPU) and three decode steps of the reduced config,
    same params and inputs, within 1e-4 (fp32, TF32 off)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry
    cfg = get_config(arch).reduced()
    api = registry.get_api(cfg)
    gen = torch.Generator().manual_seed(11)
    p_cpu = api.init(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    steps = torch.randint(0, cfg.vocab_size, (3, 2, 1), generator=gen)
    kw = {}
    stub = {"vlm": "img_embeds", "encdec": "audio_embeds"}.get(cfg.family)
    if stub:
        kw[stub] = 0.02 * torch.randn(
            (2, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
    runs = {}
    for dev in ("cpu", card):
        p = _tree_to(p_cpu, dev)
        logits, cache, pos = api.prefill(
            cfg, p, tokens.to(dev), max_len=60,
            **{k: v.to(dev) for k, v in kw.items()})
        out = [(logits.cpu(), _snapshot(cache))]
        for tok in steps:
            logits, cache = api.decode_step(cfg, p, cache, tok.to(dev), pos)
            pos = pos + 1
            out.append((logits.cpu(), _snapshot(cache)))
        runs[str(dev)] = out
    for (lg, cg), (lw, cw) in zip(runs[str(card)], runs["cpu"]):
        assert float((lg - lw).abs().max()) <= 1e-4
        _tree_close(cg, cw, 1e-4)


# ---------------------------------------------------------------------------
# the flash kernel's backward, and the guard of the kernels without one
# ---------------------------------------------------------------------------

def _bwd_mode(Sq, Skv, Hkv, kw):
    """``flash_mha``'s mode for ``kw``, block sizes clipped as it clips
    them."""
    mode = {**dict(n_kv_heads=Hkv, causal=True, q_offset=0, window=0,
                   sink=0, sparsity=0.0, block_q=128, block_kv=128), **kw}
    mode["block_q"] = min(mode["block_q"], Sq)
    mode["block_kv"] = min(mode["block_kv"], Skv)
    return mode


def bwd_limit(want):
    """fp32: 1e-4 of the gradient's largest magnitude; bf16: 4 bf16 ulps
    at it (each side rounds one fp32 sum, in another order)."""
    top = float(want.float().abs().max())
    if want.dtype == torch.float32:
        return 1e-4 * max(top, 1e-30)
    return 4.0 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


@pytest.mark.parametrize("mode", list(FLASH_MODES))
@pytest.mark.parametrize("D", [16, 64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_backward_matches_plain_version(card, mode, D, dtype):
    """``flash_mha_bwd`` against ``flash_mha_bwd_ref`` on the same q, k,
    v, output, lse and output gradient from the forward kernel: bf16 at
    D 64 / 96 / 128 on the tensor cores against the rounding plain
    version, the rest on the CUDA cores against the unrounded one; the
    forward's lse against the plain version's; two calls bit for bit."""
    Sq, Skv, Hq, Hkv, kw = FLASH_MODES[mode]
    g = torch.Generator(device=card).manual_seed(7 * Sq + D)
    q = torch.randn((2, Sq, Hq, D), generator=g, device=card).to(dtype)
    k = torch.randn((2, Skv, Hkv, D), generator=g, device=card).to(dtype)
    v = torch.randn((2, Skv, Hkv, D), generator=g, device=card).to(dtype)
    do = torch.randn((2, Sq, Hq, D), generator=g, device=card).to(dtype)
    m = _bwd_mode(Sq, Skv, Hkv, kw)
    out, lse = fops._launch(q, k, v, with_lse=True, **m)
    _, lse0 = fref.flash_mha_ref(q, k, v, return_lse=True, **m)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse0))
    fin = torch.isfinite(lse0)
    if fin.any():
        assert float((lse - lse0)[fin].abs().max()) <= 2e-4
    tc = fops.bwd_kernel_path(dtype, D) == "wgmma"
    assert tc == (dtype == torch.bfloat16 and D != 16)
    before = fops.flash_mha.launches_bwd, fops.flash_mha.launches_bwd_tc
    got = fops.flash_mha_bwd(q, k, v, out, lse, do, **m)
    again = fops.flash_mha_bwd(q, k, v, out, lse, do, **m)
    torch.cuda.synchronize()
    assert (fops.flash_mha.launches_bwd, fops.flash_mha.launches_bwd_tc) \
        == (before[0] + 2, before[1] + 2 * tc)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fref.flash_mha_bwd_ref(q, k, v, out, lse, do, round_bf16=tc, **m)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape
        err = float((a.float() - w.float()).abs().max())
        assert err <= bwd_limit(w), (mode, D, dtype, name, err)
    if mode == "rows-see-nothing":
        assert float(got[0][:, :8].float().abs().max()) == 0.0


def test_flash_autograd_on_the_card(card):
    """Under grad ``flash_mha``'s output has a ``grad_fn`` (``FlashMHA``)
    and ``backward`` launches the backward kernel once, giving its
    gradients (GQA: the group's heads summed into dK / dV)."""
    g = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn(s, generator=g, device=card).to(torch.bfloat16)
               for s in ((2, 200, 8, 64), (2, 300, 2, 64), (2, 300, 2, 64)))
    do = torch.randn((2, 200, 8, 64), generator=g, device=card) \
        .to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fops.flash_mha.launches_bwd, fops.flash_mha.launches_bwd_tc
    out = fops.flash_mha(*leaves, n_kv_heads=2, causal=False)
    assert out.grad_fn is not None
    out.backward(do)
    assert (fops.flash_mha.launches_bwd, fops.flash_mha.launches_bwd_tc) \
        == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        o, lse = fops._launch(q, k, v, with_lse=True,
                              **_bwd_mode(200, 300, 2, dict(causal=False)))
        want = fops.flash_mha_bwd(q, k, v, o, lse, do, **_bwd_mode(
            200, 300, 2, dict(causal=False)))
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    with torch.no_grad():
        assert fops.flash_mha(*leaves, n_kv_heads=2,
                              causal=False).grad_fn is None


def test_flash_autograd_takes_the_tensor_cores_at_d128(card):
    """``FlashMHA.backward`` on bf16 at D 128 (the AR-DiT's heads) runs
    the tensor-core backward: one launch counted in ``launches_bwd_tc``,
    its gradients those of a direct call."""
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v, do = (torch.randn(s, generator=g, device=card).to(torch.bfloat16)
                   for s in ((1, 264, 4, 128), (1, 341, 4, 128),
                             (1, 341, 4, 128), (1, 264, 4, 128)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fops.flash_mha.launches_bwd, fops.flash_mha.launches_bwd_tc
    fops.flash_mha(*leaves, n_kv_heads=4, causal=False).backward(do)
    assert (fops.flash_mha.launches_bwd, fops.flash_mha.launches_bwd_tc) \
        == (before[0] + 1, before[1] + 1)
    m = _bwd_mode(264, 341, 4, dict(causal=False))
    with torch.no_grad():
        o, lse = fops._launch(q, k, v, with_lse=True, **m)
        want = fops.flash_mha_bwd(q, k, v, o, lse, do, path="wgmma", **m)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


@pytest.mark.parametrize("mode", ["causal-offset", "rho-keep", "gqa-4"])
def test_flash_backward_cuda_cores_on_request(card, mode):
    """The CUDA-core backward stays callable where the tensor cores would
    run (bf16 at D 128, ``path="cuda_cores"``): no tensor-core launch,
    the unrounded plain version within 4 bf16 ulps."""
    Sq, Skv, Hq, Hkv, kw = FLASH_MODES[mode]
    g = torch.Generator(device=card).manual_seed(11)
    q, do = (torch.randn((2, Sq, Hq, 128), generator=g, device=card)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((2, Skv, Hkv, 128), generator=g, device=card)
            .to(torch.bfloat16) for _ in range(2))
    m = _bwd_mode(Sq, Skv, Hkv, kw)
    out, lse = fops._launch(q, k, v, with_lse=True, **m)
    before = fops.flash_mha.launches_bwd, fops.flash_mha.launches_bwd_tc
    got = fops.flash_mha_bwd(q, k, v, out, lse, do, path="cuda_cores", **m)
    torch.cuda.synchronize()
    assert (fops.flash_mha.launches_bwd, fops.flash_mha.launches_bwd_tc) \
        == (before[0] + 1, before[1])
    want = fref.flash_mha_bwd_ref(q, k, v, out, lse, do, **m)
    for a, w in zip(got, want):
        assert float((a.float() - w.float()).abs().max()) <= bwd_limit(w)


def test_kernels_without_a_backward_raise_under_grad(card):
    """The SSD, fp8 and both paged wrappers raise before they launch when
    grad mode is on and an input requires grad (their outputs would leave
    autograd); under ``torch.no_grad()`` they launch."""
    x, dt, A, Bm, Cm, _ = ssd_inputs(card, 1, 64, 2, 16, 16, torch.float32,
                                     False, 0)
    xq = to_fp8_e4m3(torch.randn((32, 64), device=card))
    wq = to_fp8_e4m3(torch.randn((64, 32), device=card))
    sx = torch.ones((32, 1), device=card)
    sw = torch.ones((1, 32), device=card)
    q, kp, vp, table, mask = _inputs(card, 1, 16, 4, 4, 16, 8, 2,
                                     torch.float32, torch.float32, 0)
    dq, dkp, dvp, dtable, lengths = _decode_inputs(
        card, 2, 4, 4, 16, 8, 2, 6, torch.float32, 0)
    calls = {
        "ssd": lambda: sops.ssd(x.requires_grad_(), dt, A, Bm, Cm, chunk=16),
        "fp8_scaled_matmul": lambda: f8ops.fp8_scaled_matmul(
            xq, wq, sx.requires_grad_(), sw),
        "paged_chunk_attention": lambda: ops.paged_chunk_attention(
            q.requires_grad_(), kp, vp, table, mask),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            dq.requires_grad_(), dkp, dvp, dtable, lengths),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel "
                                               "has no backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch", ["minitron-8b", "ardit-self-forcing"])
def test_training_gradients_on_the_card_match_the_cpu(card, arch):
    """A reduced config's loss and gradients on the card (fp32: kernel 3
    on the CUDA cores, its backward) within 1e-4 of each leaf's largest
    magnitude of the CPU's, on the same parameters and batch."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.models import ardit, registry
    from repro_torch.models.convert import params_to
    from repro_torch.train import loop, optimizer as opt
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config(arch).reduced()
        gen = torch.Generator().manual_seed(0)
        params = registry.get_api(cfg).init(cfg, gen, device="cpu")
        seq = 24
        if cfg.family == "ardit":
            params = ardit.open_gates(params, gen)
            seq = 2 * ardit.chunk_tokens(cfg)
        batch = dp.global_batch(cfg, ShapeConfig("t", "train", seq, 2), 0)
        fn = loop.loss_for(cfg)
        l0, g0 = loop.value_and_grad(fn, params, loop.to_device(batch, "cpu"))
        before = fops.flash_mha.launches_bwd
        l1, g1 = loop.value_and_grad(fn, params_to(params, card),
                                     loop.to_device(batch, card))
        assert fops.flash_mha.launches_bwd > before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert abs(float(l1) - float(l0)) <= 1e-4 * abs(float(l0))
    want = dict(opt.leaves_with_path(g0))
    for path, t in opt.leaves_with_path(g1):
        w = want[path]
        assert float((t.cpu() - w).abs().max()) <= 1e-4 * max(
            float(w.abs().max()), 1e-30), path


# ---- the seeded form: paged_mha's in-chunk segment on the tensor cores ----

def _segment_inputs(dev, B, Sq, Hq, Hkv, D, page, n, seed):
    """bf16 q, a pool of B n + 1 pages, tables, a token mask and the
    chunk's own k / v (what paged_mha takes at the cell's shapes)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, Hq, D), generator=g, device=dev).bfloat16()
    kp, vp = (torch.randn((B * n + 1, page, Hkv, D), generator=g,
                          device=dev).bfloat16() for _ in range(2))
    table = torch.arange(B * n, dtype=torch.int32, device=dev).view(B, n)
    mask = torch.rand((B, n * page), generator=g, device=dev) < 0.6
    ck, cv = (torch.randn((B, Sq, Hkv, D), generator=g, device=dev)
              .bfloat16() for _ in range(2))
    return q, kp, vp, table, mask, ck, cv


def _segment_against_plain(q, kp, vp, table, mask, ck, cv, Hkv, hint,
                           views=False):
    """paged_mha on the seeded form against kernel 1's same partials
    finished by the plain version (``flash_mha_seeded_ref``), within kernel
    1's bf16 limit (2 bf16 ulps at the output's largest magnitude); one
    seeded launch a call, none on the plain path; a second call bit for
    bit.  Returns the output."""
    before = (fops.flash_mha.launches_seeded, fops.flash_mha.plain_segments)
    got = paged_mha(q, kp, vp, table, mask, ck, cv, n_kv_heads=Hkv, **hint)
    again = paged_mha(q, kp, vp, table, mask, ck, cv, n_kv_heads=Hkv, **hint)
    ctx = ops.paged_chunk_attention(q, kp, vp, table, mask, **hint)
    want = fref.flash_mha_seeded_ref(q, ck, cv, *ctx, n_kv_heads=Hkv)
    torch.cuda.synchronize()
    assert (fops.flash_mha.launches_seeded,
            fops.flash_mha.plain_segments) == (before[0] + 2, before[1])
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=flash_limit(want))
    return got


@pytest.mark.parametrize("B", [1, 2, 3, 4])
def test_seeded_segment_at_the_cells_shape(card, B):
    """ardit-self-forcing at 832x480: 4,680 queries (36 tiles of 128 and
    one of 72) over their chunk's own 4,680 keys and two 4,680-token pages
    behind a 77-token sink, 12 heads of 128, bf16 pages, 1-4 rows."""
    Sq, H, D, page, n = 4680, 12, 128, 4680, 3
    q, kp, vp, table, _, ck, cv = _segment_inputs(card, B, Sq, H, H, D,
                                                  page, n, seed=4680 + B)
    assert fops.seeded_path(q.dtype, D) == "wgmma"
    _segment_against_plain(q, kp, vp, table, None, ck, cv, H,
                           dict(sink=77, chunk_tokens=page))


def test_seeded_segment_at_causal_forcings_heads(card):
    """ardit-causal-forcing's 16 heads of 96 (two 64-column boxes, the
    second half zeros) at its 2,640-token chunk, 2 rows, bf16 pages on
    kernel 1's D 96 instance."""
    B, Sq, H, D, page, n = 2, 2640, 16, 96, 2640, 3
    q, kp, vp, table, _, ck, cv = _segment_inputs(card, B, Sq, H, H, D,
                                                  page, n, seed=96)
    _segment_against_plain(q, kp, vp, table, None, ck, cv, H,
                           dict(sink=77, chunk_tokens=page))


@pytest.mark.parametrize("Sq,Hq,Hkv,D", [(70, 4, 4, 128), (1000, 12, 12, 128),
                                         (300, 8, 2, 96), (129, 6, 3, 128)],
                         ids=["70", "1000", "300-gqa-4-d96", "129-gqa-2"])
def test_seeded_segment_at_ragged_lengths(card, Sq, Hq, Hkv, D):
    """Lengths that are not multiples of 128 (one item with rows past Sq,
    a last key tile of 104, one of 1), GQA, a page mask."""
    B, page, n = 2, 200, 3
    q, kp, vp, table, mask, ck, cv = _segment_inputs(card, B, Sq, Hq, Hkv,
                                                     D, page, n, seed=Sq)
    _segment_against_plain(q, kp, vp, table, mask, ck, cv, Hkv, {})


def test_seeded_segment_rows_that_see_no_context(card):
    """A row whose page mask hides every context token (kernel 1's seed m =
    -1e30, l = 0) and a fully-masked page: the row is attention over its
    chunk alone."""
    B, Sq, H, D, page, n = 3, 600, 4, 128, 300, 3
    q, kp, vp, table, mask, ck, cv = _segment_inputs(card, B, Sq, H, H, D,
                                                     page, n, seed=600)
    mask3 = mask.view(B, n, page)
    mask3[0, 1] = False
    mask3[2] = False
    got = _segment_against_plain(q, kp, vp, table, mask, ck, cv, H, {})
    alone = fref.flash_mha_ref(q[2:], ck[2:], cv[2:], n_kv_heads=H,
                               causal=False)
    torch.testing.assert_close(got[2:].float(), alone.float(), rtol=0,
                               atol=flash_limit(alone))


def test_seeded_segment_reads_head_range_views(card):
    """Elastic SP2: each half of the KV heads as its own paged_mha call,
    the pools and the chunk's k / v as head-range views of the full
    tensors (read in place), gives the full call's heads bit for bit."""
    B, Sq, H, D, page, n = 2, 700, 12, 128, 400, 3
    q, kp, vp, table, mask, ck, cv = _segment_inputs(card, B, Sq, H, H, D,
                                                     page, n, seed=2)
    full = _segment_against_plain(q, kp, vp, table, mask, ck, cv, H, {})
    outs = []
    for lo, hi in ((0, 6), (6, 12)):
        before = fops.flash_mha.launches_seeded
        outs.append(paged_mha(
            shard_heads(q, H, lo, hi).contiguous(), kp[..., lo:hi, :],
            vp[..., lo:hi, :], table, mask, shard_heads(ck, H, lo, hi),
            shard_heads(cv, H, lo, hi), n_kv_heads=hi - lo))
        assert fops.flash_mha.launches_seeded == before + 1
    assert not shard_heads(ck, H, 6, 12).is_contiguous()
    merged = merge_head_shards(outs, [6, 6])
    assert torch.equal(merged.view(torch.int16), full.view(torch.int16))


def test_seeded_segment_paths_and_refusals(card):
    """fp32 and D 64 on the card keep the plain path (counted, no launch,
    the plain version's bits); the seeded op refuses mixed dtypes,
    partials of the wrong dtype, k whose heads are not dense and inputs
    that need a gradient."""
    q, kp, vp, table, mask, ck, cv = _segment_inputs(card, 1, 40, 2, 2, 128,
                                                     50, 2, seed=1)
    f = [t.float() for t in (q, kp, vp, ck, cv)]
    before = (fops.flash_mha.launches_seeded, fops.flash_mha.plain_segments)
    paged_mha(f[0], f[1], f[2], table, mask, f[3], f[4], n_kv_heads=2)
    torch.cuda.synchronize()
    assert (fops.flash_mha.launches_seeded,
            fops.flash_mha.plain_segments) == (before[0], before[1] + 1)
    m, l, acc = ops.paged_chunk_attention(q, kp, vp, table, mask)
    q64, ck64, cv64 = (t[..., :64].contiguous() for t in (q, ck, cv))
    for args in ((f[0], f[3], f[4], m, l, acc),
                 (q64, ck64, cv64, m, l, acc[..., :64].contiguous())):
        got = fops.flash_mha_seeded(*args, n_kv_heads=2)
        assert torch.equal(got, fref.flash_mha_seeded_ref(*args,
                                                          n_kv_heads=2))
    assert (fops.flash_mha.launches_seeded,
            fops.flash_mha.plain_segments) == (before[0], before[1] + 3)
    with pytest.raises(TypeError, match="no kernel"):
        fops.flash_mha_seeded(q, f[3], f[4], m, l, acc, n_kv_heads=2)
    with pytest.raises(ValueError, match="fp32"):
        fops.flash_mha_seeded(q, ck, cv, m.bfloat16(), l, acc, n_kv_heads=2)
    with pytest.raises(ValueError, match="dense"):
        fops.flash_mha_seeded(q, ck.transpose(2, 3).contiguous()
                              .transpose(2, 3), cv, m, l, acc, n_kv_heads=2)
    with pytest.raises(RuntimeError, match="no backward"):
        fops.flash_mha_seeded(q.requires_grad_(), ck, cv, m, l, acc,
                              n_kv_heads=2)
