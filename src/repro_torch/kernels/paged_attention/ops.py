"""Wrappers of the two paged attention kernels.

``paged_chunk_attention`` (chunk-query partials, the batched serving
executor's hot path; ``csrc/paged_chunk_attention.cu``) and
``paged_decode_attention`` (one-token decode with per-stream lengths;
``csrc/paged_decode_attention.cu``).  A CPU tensor takes the plain
PyTorch version (``ref.py``); a CUDA tensor launches the hand-written
CUDA kernel (built with nvcc at first use) or raises.  There is no
fallback between the two.  ``kernel_path`` picks the chunk kernel from
the dtypes, head dim and group alone: bf16 queries over bf16 or e4m3
pages at D 96 or 128 with a group dividing 128 (every full-width model)
run on the tensor cores (wgmma fed by TMA through the page table),
everything else on the CUDA cores; ``decode_kernel_path`` sends bf16
decode queries over bf16 or e4m3 pages at D 64 or 128 (minitron-8b's
decode) to the split, TMA-fed tensor-core decode kernel.  Each wrapper's
``launches`` counts its kernel launches; ``launches_tc`` counts the
tensor-core launches among them (the chunk kernel's and the decode
kernel's), ``view_launches`` those that read
a head-range view of a wider pool (elastic SP2's half-head shards), and
the chunk kernel's ``launches_by_dim`` its launches per head dim (two
co-served models of different head dims share the one kernel).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.common.grad import no_grad_through
from repro_torch.kernels.paged_attention import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_chunk_attention.cu"
DECODE_SOURCE = SOURCE.parent / "paged_decode_attention.cu"

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
# the configs' head dims: reduced 16, ardit-causal-forcing 96,
# ardit-self-forcing 128
_HEAD_DIMS = (16, 96, 128)
# the tensor-core kernel's head dims and page dtypes
WGMMA_HEAD_DIMS = (96, 128)
_WGMMA_KV_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)


def kernel_path(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_dim: int,
                group: int) -> str:
    """The CUDA kernel that takes chunk queries of ``q_dtype`` over pages
    of ``kv_dtype`` at ``head_dim`` with ``group`` = Hq / Hkv query heads
    per KV head: ``"wgmma"`` for bf16 queries over bf16 or e4m3 pages at
    D 96 or 128 with a group that divides 128 (a block's 128 query rows
    are whole groups), else ``"cuda_cores"`` (fp32 FMAs: fp32 queries or
    pages keep their 1e-4 agreement with the CPU; D 16 is the reduced
    configs')."""
    if q_dtype == torch.bfloat16 and kv_dtype in _WGMMA_KV_DTYPES \
            and head_dim in WGMMA_HEAD_DIMS and group > 0 \
            and 128 % group == 0:
        return "wgmma"
    return "cuda_cores"


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.paged_chunk_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 \
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        tc = lib.paged_chunk_attention_wgmma_launch
        tc.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 \
            + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
        tc.restype = ctypes.c_int
        lib.paged_chunk_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_chunk_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k_pages, v_pages, block_table, page_mask, sink,
            chunk_tokens):
    b, sq, hq, d = q.shape
    n_total, page, hkv, dk = k_pages.shape
    n = block_table.shape[1]
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"query dtype {q.dtype} not supported")
    if k_pages.dtype not in _KV_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"page dtypes {k_pages.dtype}/{v_pages.dtype}")
    if d != dk or d not in _HEAD_DIMS or hq % hkv:
        raise ValueError(f"head dims q {q.shape} vs pages {k_pages.shape}")
    if v_pages.shape != k_pages.shape or block_table.shape[0] != b:
        raise ValueError("pool / table shapes disagree")
    # the pools may be head-range views pool[..., lo:hi, :] of a wider
    # pool (elastic SP2's shards): the kernel reads them in place
    # through their page and token strides; heads and D must be dense
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{name}: the inner two dims (heads, D) must "
                             f"be dense, strides {t.stride()}")
    if v_pages.stride() != k_pages.stride():
        raise ValueError("k_pages and v_pages strides differ")
    table = block_table.to(torch.int32).contiguous()
    if page_mask is None:
        if not (sink and chunk_tokens):
            raise ValueError(
                "page_mask=None needs the sink/chunk_tokens layout hint")
        mask = None
        page_any = torch.ones((b, n), dtype=torch.uint8, device=dev)
    else:
        if page_mask.shape != (b, n * page) or page_mask.device != dev:
            raise ValueError(f"page_mask {tuple(page_mask.shape)} on "
                             f"{page_mask.device}")
        mask = page_mask.to(torch.uint8).contiguous()
        page_any = mask.view(b, n, page).amax(dim=-1).contiguous()
    g = hq // hkv
    tc = kernel_path(q.dtype, k_pages.dtype, d, g) == "wgmma"
    if tc and any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("the tensor-core path reads q and the pools by "
                         "TMA: they must be 16-byte aligned")
    m = torch.empty((b, hkv, g, sq), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    lib = _lib()
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), None if mask is None else mask.data_ptr(),
            page_any.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            b, sq, hq, hkv, d, page, n, int(sink), int(chunk_tokens),
            _Q_DTYPES[q.dtype], _KV_DTYPES[k_pages.dtype], k_pages.stride(0),
            k_pages.stride(1))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):        # the runtime launches on its device
        if tc:
            err = lib.paged_chunk_attention_wgmma_launch(*args, n_total,
                                                         stream)
        else:
            err = lib.paged_chunk_attention_launch(*args, stream)
    if err != 0:
        msg = lib.paged_chunk_attention_error_string(err).decode()
        raise RuntimeError(f"paged_chunk_attention launch failed: {msg}")
    paged_chunk_attention.launches += 1
    paged_chunk_attention.launches_tc += int(tc)
    by_dim = paged_chunk_attention.launches_by_dim
    by_dim[d] = by_dim.get(d, 0) + 1
    if k_pages.stride(1) != hkv * d:
        paged_chunk_attention.view_launches += 1
    return m, l, acc


def paged_chunk_attention(q, k_pages, v_pages, block_table, page_mask,
                          *, sink: int = 0, chunk_tokens: int = 0):
    """Chunk-query paged attention partials (the serving executor's
    paged context backend).  q [B,Sq,Hq,D]; pages [P_total,page,Hkv,D]
    — the whole pool, or a head-range view ``pool[..., lo:hi, :]`` of a
    wider one, read in place (elastic SP2's shards); block_table [B,n];
    page_mask [B,n*page] bool, or None for the all-visible path (then
    ``sink``/``chunk_tokens`` are required).
    ``sink``/``chunk_tokens`` declare the valid prefix of the sink page
    / ring pages: both forms then read only that prefix.  ``page_mask``
    is per-ROW, so one launch serves rows of different fidelity windows
    and sparsities, and rows degraded by page eviction (a dropped ring
    page's hole entry points at the stream's sink page with its whole
    mask slice false, so it never contributes).  Returns fp32
    online-softmax partials (m, l [B,Hkv,G,Sq]; acc [B,Hkv,G,Sq,D]
    unnormalized) for ``attention.paged_mha`` to merge with the chunk's
    own fresh KV."""
    if q.device.type == "cpu":
        return _ref.paged_chunk_attention_ref(
            q, k_pages, v_pages, block_table, page_mask,
            sink=sink, chunk_tokens=chunk_tokens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_chunk_attention: no kernel for device "
                         f"{q.device}")
    no_grad_through("paged_chunk_attention", q, k_pages, v_pages)
    return _launch(q, k_pages, v_pages, block_table, page_mask, sink,
                   chunk_tokens)


paged_chunk_attention.launches = 0
paged_chunk_attention.launches_tc = 0
paged_chunk_attention.view_launches = 0
paged_chunk_attention.launches_by_dim = {}


# the decode kernel: q (and the output) in fp32 or bf16, the pools in
# fp32, bf16 or fp8-e4m3, any q dtype with any page dtype, as the TPU
# kernel widens all three to fp32; head dims of the reference tests and
# the token configs (minitron-8b: 128)
_DECODE_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DECODE_HEAD_DIMS = (16, 32, 64, 128)


def decode_dtypes_supported(q_dtype: torch.dtype,
                            kv_dtype: torch.dtype) -> bool:
    """Whether the decode kernel takes q of ``q_dtype`` over pages of
    ``kv_dtype``: q fp32 or bf16, pages fp32, bf16 or fp8-e4m3."""
    return q_dtype in _DECODE_Q_DTYPES and kv_dtype in _KV_DTYPES


# the decode kernel's tensor-core path: bf16 q over bf16 or e4m3 pages at
# these head dims with a group of at most 8, pages of 8, 16 or a multiple
# of the 32-token tile; units of at most 2048 tokens
DECODE_MMA_HEAD_DIMS = (64, 128)
DECODE_TILE = 32
DECODE_MAX_UNIT = 2048


def decode_kernel_path(q_dtype: torch.dtype, kv_dtype: torch.dtype,
                       head_dim: int, group: int, page: int) -> str:
    """The CUDA kernel that takes one-token decode queries of ``q_dtype``
    over pages of ``kv_dtype``: ``"mma"`` (split over the sequence, K/V
    by TMA through the page table, products on the tensor cores) for
    bf16 q over bf16 or e4m3 pages at D 64 or 128 with ``group`` = Hq /
    Hkv at most 8 and ``page`` 8, 16 or a multiple of 32 tokens, else
    ``"cuda_cores"`` (fp32 FMAs: fp32 q or pages keep their 1e-5
    agreement with the CPU; the other head dims)."""
    if q_dtype == torch.bfloat16 and kv_dtype in _WGMMA_KV_DTYPES \
            and head_dim in DECODE_MMA_HEAD_DIMS and 0 < group <= 8 \
            and (page in (8, 16) or (page > 0 and page % DECODE_TILE == 0)):
        return "mma"
    return "cuda_cores"


def decode_unit_tokens(batch: int, kv_heads: int, max_tokens: int) -> int:
    """Tokens per work unit of the tensor-core path, from the shapes
    alone (no look at the lengths, so no host sync): 2048, halved down
    to 256 while the grid would have fewer than 1024 units of (b, KV
    head) at ``max_tokens`` (= table entries x page), so that one long
    stream still spreads over the card."""
    unit = DECODE_MAX_UNIT
    while unit > 256 and \
            batch * kv_heads * -(-max_tokens // unit) < 1024:
        unit //= 2
    return unit


def decode_units(lengths, n: int, page: int, unit: int):
    """The tensor-core path's work plan, as its grid makes it on the
    card: (b, u, first page entry, first token, tokens) for every unit
    of ``unit`` tokens that holds a visible token of stream b; lengths
    are clamped to [0, n * page].  Every visible token lies in exactly
    one unit, and none at or past ``lengths[b]``."""
    cap = n * page
    out = []
    for b, ln in enumerate(int(x) for x in lengths):
        ln = min(max(ln, 0), cap)
        for u in range(-(-cap // unit)):
            t0 = u * unit
            if t0 < ln:
                out.append((b, u, t0 // page, t0, min(unit, ln - t0)))
    return out


def _decode_lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(DECODE_SOURCE)
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        tc = lib.paged_decode_attention_mma_launch
        tc.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        tc.restype = ctypes.c_int
        lib.paged_decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch_decode(q, k_pages, v_pages, block_table, lengths):
    b, hq, d = q.shape
    n_pages, page, hkv, dk = k_pages.shape
    n = block_table.shape[1]
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if v_pages.dtype != k_pages.dtype or not decode_dtypes_supported(
            q.dtype, k_pages.dtype):
        raise TypeError(f"dtypes q {q.dtype}, pages {k_pages.dtype}/"
                        f"{v_pages.dtype}: q float32 or bfloat16, both "
                        f"pools one of float32, bfloat16, float8_e4m3fn")
    if d != dk or d not in _DECODE_HEAD_DIMS or hq % hkv:
        raise ValueError(f"head dims q {q.shape} vs pages {k_pages.shape}")
    if v_pages.shape != k_pages.shape or block_table.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError("pool / table / lengths shapes disagree")
    if not (q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous()):
        raise ValueError("q and the page pools must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and the page pools must be 16-byte aligned")
    table = block_table.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _decode_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tc = decode_kernel_path(q.dtype, k_pages.dtype, d, hq // hkv,
                            page) == "mma"
    if tc:
        unit = decode_unit_tokens(b, hkv, n * page)
        units = -(-(n * page) // unit)
        m = torch.empty((b, hq, units), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        acc = torch.empty((b, hq, units, d), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):    # the runtime launches on its device
            err = lib.paged_decode_attention_mma_launch(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                table.data_ptr(), ln.data_ptr(), out.data_ptr(),
                m.data_ptr(), l.data_ptr(), acc.data_ptr(), b, hq, hkv, d,
                page, n, n_pages, _KV_DTYPES[k_pages.dtype], unit, stream)
    else:
        with torch.cuda.device(dev):
            err = lib.paged_decode_attention_launch(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                table.data_ptr(), ln.data_ptr(), out.data_ptr(), b, hq,
                hkv, d, page, n, _DECODE_Q_DTYPES[q.dtype],
                _KV_DTYPES[k_pages.dtype], stream)
    if err != 0:
        msg = lib.paged_decode_attention_error_string(err).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: {msg}")
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_tc += int(tc)
    return out


def paged_decode_attention(q, k_pages, v_pages, block_table, lengths):
    """One-token decode over the paged pool.  q [B,Hq,D]; pages
    [P_total,page,Hkv,D]; block_table [B,n]; lengths [B] valid tokens
    per stream -> [B,Hq,D] in q's dtype (q fp32 or bf16; pages fp32,
    bf16 or fp8-e4m3, all widened to fp32).  Tokens at or past
    ``lengths[b]`` are masked and their pages never read.  A stream of
    length 0 gives 0 from the kernel (as the TPU kernel does) and NaN
    from the plain version (as the reference's oracle does)."""
    if q.device.type == "cpu":
        return _ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                               block_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    no_grad_through("paged_decode_attention", q, k_pages, v_pages)
    return _launch_decode(q, k_pages, v_pages, block_table, lengths)


paged_decode_attention.launches = 0
paged_decode_attention.launches_tc = 0
