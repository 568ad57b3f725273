"""``paged_mha``'s in-chunk segment off the card, on the CPU.

``flash_attention.ops.seeded_path`` sends bf16 at D 96 and 128 (the
AR-DiT configs on the card) to the tensor-core kernel's seeded form
(``flash_mha_seeded``) and everything else to its plain version
(``ref.flash_mha_seeded_ref``); CPU tensors always take the plain
version.  Checked here: the path chooser's choice for each dtype and head
dim and for the configs; ``paged_mha`` on CPU tensors bit for bit equal
to the segment written out (the fp32 segment over the chunk's own keys,
the merge with the context's partials, the divide, the layout), in fp32
and bf16, with and without a page mask; the plain version against dense
masked attention over the visible context and the chunk together
(``mha_plain`` with a key mask, float64), a row that sees no context
included; the counters (``flash_mha.plain_segments``,
``flash_mha.launches_seeded`` and the tracer's counters of those names,
their rise while it records); the wrapper taking the plain version for
CPU tensors and refusing other devices.  The kernel is held to the plain version on the card by
``tests/test_torch_kernel_cuda.py``.
"""
import math

import pytest

pytest.importorskip("torch")

import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.models import attention as A
from repro_torch.profiler import trace

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True)
def tracing_off():
    trace.stop()
    yield
    trace.stop()


@pytest.mark.parametrize("dtype,head_dim,path", [
    (BF16, 128, "wgmma"), (BF16, 96, "wgmma"), (BF16, 64, "plain"),
    (BF16, 16, "plain"), (F32, 128, "plain"), (F32, 96, "plain"),
    (F32, 16, "plain"), (torch.float64, 128, "plain")])
def test_seeded_path_by_dtype_and_head_dim(dtype, head_dim, path):
    assert fops.seeded_path(dtype, head_dim) == path


@pytest.mark.parametrize("arch", ["ardit-self-forcing",
                                  "ardit-causal-forcing"])
def test_ardit_segments_take_the_seeded_form_at_full_width(arch):
    cfg = get_config(arch)
    assert fops.seeded_path(BF16, cfg.head_dim) == "wgmma"
    assert fops.seeded_path(F32, cfg.reduced().head_dim) == "plain"


def _case(seed, B, Sq, Hq, Hkv, D, page, n, dtype):
    """q, a pool of B n + 1 pages, tables, a token mask (about 60% of the
    context visible) and the chunk's own k / v."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Sq, Hq, D), generator=g).to(dtype)
    kp, vp = (torch.randn((B * n + 1, page, Hkv, D), generator=g).to(dtype)
              for _ in range(2))
    table = torch.randperm(B * n + 1, generator=g)[:B * n].view(B, n).int()
    mask = torch.rand((B, n * page), generator=g) < 0.6
    ck, cv = (torch.randn((B, Sq, Hkv, D), generator=g).to(dtype)
              for _ in range(2))
    return q, kp, vp, table, mask, ck, cv


def _segment_written_out(q, ctx, ck, cv, n_kv_heads):
    """The in-chunk segment as plain PyTorch: the fp32 segment, the merge,
    the divide, the [B,Sq,Hq,D] layout."""
    b, sq, hq, d = q.shape
    own = A._segment_attn(A._group(q, n_kv_heads), ck, cv, None,
                          1.0 / math.sqrt(d))
    out = A._finalize(A._merge(ctx, own), q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


SHAPES = {  # B, Sq, Hq, Hkv, D, page, n
    "gqa-2": (2, 6, 4, 2, 16, 8, 3),
    "d128-ragged": (1, 130, 2, 2, 128, 40, 2),
    "d96-gqa-4": (3, 9, 8, 2, 96, 5, 4),
}


@pytest.mark.parametrize("masked", [False, True], ids=["hint", "masked"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cpu_segment_bit_for_bit(shape, dtype, masked):
    B, Sq, Hq, Hkv, D, page, n = SHAPES[shape]
    q, kp, vp, table, mask, ck, cv = _case(D + B, B, Sq, Hq, Hkv, D, page,
                                           n, dtype)
    hint = {} if masked else dict(sink=page - 1, chunk_tokens=page - 2)
    m = mask if masked else None
    got = A.paged_mha(q, kp, vp, table, m, ck, cv, n_kv_heads=Hkv, **hint)
    ctx = pops.paged_chunk_attention(q, kp, vp, table, m, **hint)
    want = _segment_written_out(q, ctx, ck, cv, Hkv)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(fref.flash_mha_seeded_ref(q, ck, cv, *ctx,
                                                 n_kv_heads=Hkv), want)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_version_is_attention_over_context_and_chunk(shape):
    """Against dense masked attention over the visible context tokens and
    the chunk's own, in float64; the last row sees no context."""
    B, Sq, Hq, Hkv, D, page, n = SHAPES[shape]
    q, kp, vp, table, mask, ck, cv = _case(7 * D, B, Sq, Hq, Hkv, D, page,
                                           n, F32)
    mask[-1] = False
    got = A.paged_mha(q, kp, vp, table, mask, ck, cv, n_kv_heads=Hkv)
    k_all = torch.cat([kp[table.long()].reshape(B, n * page, Hkv, D), ck], 1)
    v_all = torch.cat([vp[table.long()].reshape(B, n * page, Hkv, D), cv], 1)
    vis = torch.cat([mask, torch.ones((B, Sq), dtype=torch.bool)], 1)
    want = A.mha_plain(q.double(), k_all.double(), v_all.double(),
                       n_kv_heads=Hkv, causal=False, kv_mask=vis)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    alone = A.mha_plain(q[-1:].double(), ck[-1:].double(),
                        cv[-1:].double(), n_kv_heads=Hkv, causal=False)
    torch.testing.assert_close(got[-1:].double(), alone, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype,D", [(F32, 16), (BF16, 128)],
                         ids=["f32-d16", "bf16-d128"])
def test_plain_segments_are_counted_and_traced(dtype, D):
    """Every CPU call takes the plain path (bf16 at D 128 too: the seeded
    form is the card's), counted on ``flash_mha`` and, while the tracer
    records, in its counters, with one context and one chunk device span
    a call; no seeded launch."""
    q, kp, vp, table, mask, ck, cv = _case(3, 2, 5, 2, 2, D, 4, 2, dtype)
    before = (fops.flash_mha.plain_segments, fops.flash_mha.launches_seeded)
    A.paged_mha(q, kp, vp, table, mask, ck, cv, n_kv_heads=2)
    assert (fops.flash_mha.plain_segments,
            fops.flash_mha.launches_seeded) == (before[0] + 1, before[1])
    trace.start()
    for _ in range(3):
        A.paged_mha(q, kp, vp, table, mask, ck, cv, n_kv_heads=2)
    rec = trace.stop()
    assert dict(rec.counters) == {"flash_mha.plain_segments": 3}
    assert [s.name for s in rec.device_spans] == [
        "device.attn.context", "device.attn.chunk"] * 3
    assert fops.flash_mha.plain_segments == before[0] + 4


def test_seeded_wrapper_takes_the_plain_version_on_the_cpu():
    q, kp, vp, table, mask, ck, cv = _case(5, 2, 7, 4, 2, 96, 6, 2, BF16)
    ctx = pops.paged_chunk_attention(q, kp, vp, table, mask)
    before = (fops.flash_mha.launches_seeded, fops.flash_mha.plain_segments)
    got = fops.flash_mha_seeded(q, ck, cv, *ctx, n_kv_heads=2)
    assert torch.equal(got, fref.flash_mha_seeded_ref(q, ck, cv, *ctx,
                                                      n_kv_heads=2))
    # no kernel; one plain segment
    assert (fops.flash_mha.launches_seeded,
            fops.flash_mha.plain_segments) == (before[0], before[1] + 1)


def test_seeded_wrapper_rejects_other_devices():
    q = torch.zeros((1, 2, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fops.flash_mha_seeded(q, q, q, q, q, q, n_kv_heads=2)


def test_tracer_holds_the_rise_of_the_wrapper_counts():
    """The record holds each wrapper count's rise while it records, from
    whatever the count read at ``start()``; nothing for a count that did
    not rise (or was set back to 0 meanwhile)."""
    fn = fops.flash_mha
    saved = (fn.launches_seeded, fn.plain_segments)
    try:
        fn.launches_seeded, fn.plain_segments = 40, 7
        trace.start()
        fn.launches_seeded += 5
        fn.plain_segments = 0
        rec = trace.stop()
        assert dict(rec.counters) == {"flash_mha.launches_seeded": 5}
        trace.start()
        rec = trace.stop()
        assert dict(rec.counters) == {}
    finally:
        fn.launches_seeded, fn.plain_segments = saved


@pytest.mark.parametrize("name", ["flash_mha.launches_seeded",
                                  "flash_mha.plain_segments"])
def test_wrapper_counts_name_real_counts(name):
    """Each count the tracer reads exists on its wrapper, starting from
    an int."""
    assert name in trace._read_wrapper_counts()
    fn, attr = name.split(".")
    assert isinstance(getattr(getattr(fops, fn), attr), int)
