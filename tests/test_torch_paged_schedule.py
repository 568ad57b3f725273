"""Kernel 1's D 96 instance on the CPU: which instance a call takes, the
schedule of its persistent blocks, and its merge of a row tile's parts.

``chunk_instance`` sends bf16 queries over bf16 pages at D 96 with a
group dividing 64 (ardit-causal-forcing) to the persistent D 96
instance and every other call where ``kernel_path`` sends it.
``chunk_items`` lists the instance's items in rank order (the
``d96::item_of`` of ``csrc/paged_chunk_attention.cu``): every (part, batch
row, KV head, row tile) exactly once, the parts cut from the table's
extents alone, so a row's part boundaries are the same whatever the
heads, a view's head offset or the SM count, and the counter's schedule
evens the blocks' work at 1b's shape.  The merge's plain form
(``merge_parts``) over the plain version's partials of each part
(``part_token_mask``) equals the unsplit plain partials and the JAX
reference at D 96 within the reference's own 1e-5 (fp32, summation order
only).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.kernels.paged_attention.ref import \
    paged_chunk_attention_ref as jax_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import NEG_INF, \
    paged_chunk_attention_ref

torch.set_num_threads(2)

BF16, F32, E4M3 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
# 1b: ardit-causal-forcing's batched paged attention at the full window
ONE_B = dict(b=2, hkv=16, sq=2640, group=1, n=8, page=2640, sink=77,
             chunk_tokens=2640)


@pytest.mark.parametrize("q_dtype,kv_dtype,head_dim,group,want", [
    (BF16, BF16, 96, 1, "wgmma96"),
    (BF16, BF16, 96, 2, "wgmma96"),
    (BF16, BF16, 96, 4, "wgmma96"),
    (BF16, BF16, 96, 3, "cuda_cores"),     # a group that does not divide 128
    (BF16, BF16, 96, 128, "wgmma"),        # 128 rows a group: not 192's
    (BF16, BF16, 128, 1, "wgmma"),
    (BF16, E4M3, 96, 1, "wgmma"),
    (BF16, E4M3, 128, 4, "wgmma"),
    (F32, F32, 96, 1, "cuda_cores"),
    (BF16, F32, 96, 1, "cuda_cores"),
    (BF16, BF16, 16, 1, "cuda_cores"),
    (F32, F32, 16, 2, "cuda_cores"),
])
def test_chunk_instance(q_dtype, kv_dtype, head_dim, group, want):
    assert ops.chunk_instance(q_dtype, kv_dtype, head_dim, group) == want
    # the D 96 instance is one of the tensor-core kernel's instances
    assert (ops.kernel_path(q_dtype, kv_dtype, head_dim, group)
            == "cuda_cores") == (want == "cuda_cores")


# (b, hkv, sq, group, n, page, sink, chunk_tokens): 1b, phase 14's
# shorter contexts (sink + 1 / 3 / 6 ring pages), GQA, no hint, and a
# ragged small one
SHAPES = [
    tuple(ONE_B.values()),
    (2, 16, 2640, 1, 2, 2640, 77, 2640),
    (3, 16, 2640, 1, 4, 2640, 77, 2640),
    (1, 16, 2640, 1, 7, 2640, 77, 2640),
    (2, 4, 660, 4, 8, 2640, 77, 2640),
    (2, 8, 300, 2, 6, 2640, 0, 0),
    (3, 3, 70, 1, 5, 1000, 40, 900),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_covers_every_item_once(shape):
    b, hkv, sq, group, n, page, sink, ct = shape
    items, balance = ops.chunk_items(b, hkv, sq, group, n, page, sink, ct)
    parts = ops.chunk_parts(n, page, sink, ct)
    n_rt = -(-sq * group // ops.CHUNK_ROWS)
    want = {(p, bb, h, rt) + parts[p] for p in range(len(parts))
            for bb in range(b) for h in range(hkv) for rt in range(n_rt)}
    assert len(items) == len(want) and set(items) == want
    # the parts tile the context's key-tile positions, in order
    ext0, ext1 = ops.chunk_extents(page, sink, ct)
    n_pos = -(-ext0 // 128) + (n - 1) * -(-ext1 // 128)
    assert parts[0][0] == 0 and parts[-1][1] == n_pos
    assert all(a[1] == c[0] for a, c in zip(parts, parts[1:]))
    assert all(p1 - p0 <= ops.CHUNK_PART_TILES for p0, p1 in parts)
    # full parts first: no last part ranks before any first part
    first_last = min(r for r, it in enumerate(items)
                     if it[0] == len(parts) - 1)
    assert all(it[0] != 0 for it in items[first_last:]) or len(parts) == 1
    assert balance >= 1.0


def test_schedule_evens_the_blocks_at_1b():
    items, balance = ops.chunk_items(**ONE_B)
    assert ops.chunk_parts(8, 2640, 77, 2640) == [(0, 128), (128, 148)]
    assert len(items) == 2 * 2 * 16 * -(-2640 // ops.CHUNK_ROWS)
    assert balance <= 1.03
    # one part per row tile (1b's 448 items of 192 rows on 132 SMs: 3.4
    # waves) leaves the last wave mostly empty
    _, whole = ops.chunk_items(**ONE_B, part_tiles=148)
    assert whole > 1.15



def test_constants_match_the_kernel_source():
    """The wrapper sizes the D 96 instance's counters, scratch and items
    by its own constants: they are those of the source's d96 namespace
    (an item's rows, a thread's partial, a key tile)."""
    src = ops.SOURCE.read_text()
    d96 = src[src.index("namespace d96 {"):]

    def const(name, text=d96):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))
    assert ops.CHUNK_ROWS == 64 * const("WGS")
    assert ops.CHUNK_SLOT == (const("D") // 2 + 4) * 128
    assert ops.CHUNK_TILE == const("BN", src)


@pytest.mark.parametrize("n_sm", [132, 114, 7])
def test_part_boundaries_ignore_heads_views_and_sms(n_sm):
    """A row's parts come from the table's extents alone: the 16-head
    call, its 8-head views at offsets 0 and 8 and any SM count cut its
    context at the same key-tile positions."""
    b, sq, n, page, sink, ct = 2, 2640, 8, 2640, 77, 2640
    full, _ = ops.chunk_items(b, 16, sq, 1, n, page, sink, ct, n_sm=n_sm)
    half, _ = ops.chunk_items(b, 8, sq, 1, n, page, sink, ct, n_sm=n_sm)
    cuts = {}
    for part, bb, h, rt, p0, p1 in full:
        cuts.setdefault((bb, h, rt), []).append((p0, p1))
    for lo in (0, 8):
        view = {}
        for part, bb, h, rt, p0, p1 in half:
            view.setdefault((bb, h + lo, rt), []).append((p0, p1))
        for key, got in view.items():
            assert sorted(got) == sorted(cuts[key])


def _case(seed, B, Sq, Hq, Hkv, D, page, n, p_total):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    kp = rng.normal(size=(p_total, page, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(p_total, page, Hkv, D)).astype(np.float32)
    bt = rng.integers(0, p_total, size=(B, n)).astype(np.int32)
    mask = rng.random((B, n * page)) < 0.6
    return q, kp, vp, bt, mask


@pytest.mark.parametrize("masked", [False, True], ids=["hint", "masked"])
@pytest.mark.parametrize("part_tiles", [1, 3, 128])
def test_merged_parts_match_unsplit_and_jax(masked, part_tiles):
    """The plain version over each part's tokens, merged in part order,
    against the unsplit plain partials and the JAX reference at D 96: a
    sink of 77 behind pages of 300 (3 key tiles each), GQA 2, a hole row
    and, masked, a fully-masked page and a row that sees nothing."""
    B, Sq, Hq, Hkv, D, page, n, sink = 3, 5, 4, 2, 96, 300, 5, 77
    q, kp, vp, bt, mask = _case(part_tiles, B, Sq, Hq, Hkv, D, page, n, 12)
    bt[1, -1] = bt[1, 0]                         # a hole row ...
    mask.reshape(B, n, page)[1, -1] = False      # ... that never shows
    if masked:
        mask.reshape(B, n, page)[0, 2] = False   # a fully-masked page
        mask[2] = False                          # a row that sees nothing
    else:
        mask = None
    hint = dict(sink=sink, chunk_tokens=page - 20)
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt)]
    tmask = None if mask is None else torch.from_numpy(mask)
    whole = paged_chunk_attention_ref(*t, tmask, **hint)
    parts = ops.chunk_parts(n, page, **hint, part_tiles=part_tiles)
    assert len(parts) == (1 if part_tiles == 128 else
                          -(-(1 + (n - 1) * 3) // part_tiles))
    partials = []
    for p0, p1 in parts:
        keep = ops.part_token_mask(n, page, sink, page - 20, p0, p1)
        pm = keep.expand(B, -1) if tmask is None else tmask & keep
        partials.append(paged_chunk_attention_ref(*t, pm.contiguous(),
                                                  **hint))
    merged = ops.merge_parts(partials)
    want = [np.asarray(o) for o in jax_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, bt)),
        None if mask is None else jnp.asarray(mask), **hint)]
    for got, ref_, jx, name in zip(merged, whole, want, ("m", "l", "acc")):
        np.testing.assert_allclose(got.numpy(), ref_.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got.numpy(), jx, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    if masked:                                   # exactly (-1e30, 0, 0)
        assert (merged[0][2] == NEG_INF).all()
        assert (merged[1][2] == 0).all() and (merged[2][2] == 0).all()
    # one part that sees anything merges to its own partial, bit for bit
    empty = tuple(torch.full_like(x, NEG_INF) if i == 0 else
                  torch.zeros_like(x) for i, x in enumerate(whole))
    alone = ops.merge_parts([whole, empty, empty])
    assert all(torch.equal(a, w) for a, w in zip(alone, whole))
