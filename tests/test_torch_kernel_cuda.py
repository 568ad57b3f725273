"""The CUDA paged chunk-attention kernel against its plain PyTorch
version, on the card.

Marked ``cuda``: each test skips on a host without an NVIDIA GPU.  This
file imports no JAX, so it also runs on a machine that has only the
port's dependencies::

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernel_cuda.py

Same inputs through the kernel (CUDA tensors) and the plain version
(the same CUDA tensors, ``ref.paged_chunk_attention_ref``); every head
dim the kernel instantiates (16, 96, 128), query and page dtypes
(fp32, bf16, fp8-e4m3 pages), the all-visible path, explicit masks with
and without the extent hint, a hole row and a row that sees nothing.
Tolerance: both accumulate in fp32 and differ in summation order only —
m within 1e-4, l within 1e-4 relative, the finalized acc / l within
1e-4; rows that see nothing are exactly (NEG_INF, 0, 0).
"""
import pytest
import torch

from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.models.kvcache import to_fp8_e4m3

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


def _check(got, want):
    (m, l, acc), (m0, l0, acc0) = got, want
    dead = m0 == ref.NEG_INF
    assert torch.equal(m == ref.NEG_INF, dead)
    assert (l[dead] == 0).all() and (acc[dead] == 0).all()
    live = ~dead
    torch.testing.assert_close(m[live], m0[live], rtol=0, atol=1e-4)
    torch.testing.assert_close(l[live], l0[live], rtol=1e-4, atol=0)
    o = acc / torch.where(l == 0, 1.0, l)[..., None]
    o0 = acc0 / torch.where(l0 == 0, 1.0, l0)[..., None]
    torch.testing.assert_close(o, o0, rtol=0, atol=1e-4)


SHAPES = [  # B, Sq, Hq, Hkv, D, page, n
    (2, 70, 4, 2, 16, 77, 3),       # reduced ardit: D 16, page 77
    (3, 65, 8, 2, 16, 40, 4),       # GQA 4, ragged row tile
    (2, 96, 16, 16, 96, 100, 3),    # ardit-causal-forcing head dim
    (2, 64, 12, 12, 128, 200, 3),   # ardit-self-forcing head dim
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
    before = ops.paged_chunk_attention.launches
    for m, hint in ((None, dict(sink=sink, chunk_tokens=tc)),
                    (mask, {}),
                    (mask, dict(sink=sink, chunk_tokens=tc))):
        _check(ops.paged_chunk_attention(q, kp, vp, table, m, **hint),
               ref.paged_chunk_attention_ref(q, kp, vp, table, m, **hint))
    torch.cuda.synchronize()
    assert ops.paged_chunk_attention.launches == before + 3


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
