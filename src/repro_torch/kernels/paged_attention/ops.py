"""Wrapper of the chunk-query paged attention kernel.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA
tensor launches the hand-written CUDA kernel
(``csrc/paged_chunk_attention.cu``, built with nvcc at first use) or
raises.  There is no fallback between the two.
``paged_chunk_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.paged_attention import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_chunk_attention.cu"

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
# the configs' head dims: reduced 16, ardit-causal-forcing 96,
# ardit-self-forcing 128
_HEAD_DIMS = (16, 96, 128)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.paged_chunk_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
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
    if not (q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous()):
        raise ValueError("q and the page pools must be contiguous")
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
    m = torch.empty((b, hkv, g, sq), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.paged_chunk_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), None if mask is None else mask.data_ptr(),
        page_any.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        b, sq, hq, hkv, d, page, n, int(sink), int(chunk_tokens),
        _Q_DTYPES[q.dtype], _KV_DTYPES[k_pages.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.paged_chunk_attention_error_string(err).decode()
        raise RuntimeError(f"paged_chunk_attention launch failed: {msg}")
    paged_chunk_attention.launches += 1
    return m, l, acc


def paged_chunk_attention(q, k_pages, v_pages, block_table, page_mask,
                          *, sink: int = 0, chunk_tokens: int = 0):
    """Chunk-query paged attention partials (the serving executor's
    paged context backend).  q [B,Sq,Hq,D]; pages [P_total,page,Hkv,D];
    block_table [B,n]; page_mask [B,n*page] bool, or None for the
    all-visible path (then ``sink``/``chunk_tokens`` are required).
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
    return _launch(q, k_pages, v_pages, block_table, page_mask, sink,
                   chunk_tokens)


paged_chunk_attention.launches = 0
