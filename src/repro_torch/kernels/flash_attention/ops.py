"""Wrapper of the flash-attention kernel, in the model layout
[B, S, H, D].

A CPU tensor takes the plain PyTorch version (``ref.flash_mha_ref``,
the plain ``mha`` body); a CUDA tensor launches a hand-written CUDA
kernel of ``csrc/flash_mha.cu`` (built with nvcc at first use) or
raises.  There is no fallback between the two.  ``kernel_path`` picks
the kernel from the dtype and head dim alone: bf16 at D 64, 96 or 128
runs on the tensor cores (wgmma fed by TMA), everything else on the CUDA
cores.  ``fwd_instance`` names the tensor-core kernel from the mode too:
at D 64 (every mode) and at D 128 causal without window, sink or rho the
kernel is persistent: one block per SM (``fwd_blocks``) computes items
of ``FWD_ITEM_QUERIES[instance]`` queries of one (b, head) in
``fwd_item``'s rank order, dealt in snake order at D 64 (``fwd_items``)
and taken from an atomic counter at D 128; D 96 and D 128's other modes
take the general tensor-core kernel.
``flash_mha.launches`` counts kernel launches,
``flash_mha.launches_tc`` the tensor-core ones among them and
``flash_mha.launches_d128_causal`` those of the D 128 causal instance.

``flash_mha_seeded`` is the kernel's seeded form, an op of its own:
``attention.paged_mha``'s in-chunk segment, whose queries attend to the
chunk's own keys with every row's online softmax continued from kernel
1's partials over the paged context, the divide and the output's layout
in the same launch.  ``seeded_path`` sends bf16 CUDA tensors at D 96 and
128 (the AR-DiT configs) to it; the rest (CPU tensors, fp32, other head
dims) keeps the plain version (``ref.flash_mha_seeded_ref``).  Built on
the D 128 causal instance's persistent design (items of 128 queries from
an atomic counter, two consumer warpgroups), non-causal, at D 96 too;
``flash_mha.launches_seeded`` counts its launches (not in ``launches``),
``flash_mha.plain_segments`` the calls that took the plain version.

Gradients: whenever grad mode is on and q, k or v requires grad,
``flash_mha`` goes through ``FlashMHA``, whose forward also keeps the
rows' log-sum-exp and whose backward is a hand-written kernel too, or on
the CPU the plain ``ref.flash_mha_bwd_ref``.  ``bwd_kernel_path`` picks
the backward kernel by the same rule as ``kernel_path``: bf16 at D 64, 96
or 128 on the tensor cores (``csrc/flash_mha_bwd_wgmma.cu``: P and dS
rounded to bf16 before the products that take them, as
``flash_mha_bwd_ref(round_bf16=True)`` does), fp32 and D 16 on the CUDA
cores (``csrc/flash_mha_bwd.cu``, fp32 throughout).  Each backward call is
three launches, counted once in ``flash_mha.launches_bwd``;
``flash_mha.launches_bwd_tc`` counts the tensor-core calls among them.

The modes are those of the reference's ``flash_mha_pallas``: causal with
``q_offset``, sink + sliding window, the static rho block keep matrix
(``keep_matrix``, at the caller's ``block_q`` x ``block_kv``
granularity) and non-causal.  rho is accepted only where ``mha``
applies it — the causal schedule without a window or sink, Sq > 1 — so
the kernel and its plain version compute one function in every mode the
wrapper takes; there Sq and Skv must divide into the blocks, since the
keep matrix is defined on whole blocks.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.common.device import sm_count as _sm_count
from repro_torch.kernels.common.grad import no_grad_through
from repro_torch.kernels.flash_attention import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_mha.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_mha_bwd.cu"
BWD_TC_SOURCE = Path(__file__).resolve().parent / "csrc" \
    / "flash_mha_bwd_wgmma.cu"
# the backward kernels' tiles: one dK/dV block per BWD_BLOCK keys of a KV
# head, one dQ block per BWD_BLOCK queries of a query head; BWD_TC_BLOCK on
# the tensor cores, whose lse / delta scratch rows are padded to it
BWD_BLOCK = 64
BWD_TC_BLOCK = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the configs' head dims: reduced 16; granite-moe, qwen3-moe, minicpm and
# whisper-medium 64; ardit-causal-forcing 96; the rest 128
_HEAD_DIMS = (16, 64, 96, 128)
# the head dims of the tensor-core kernel (every full-width model)
WGMMA_HEAD_DIMS = (64, 96, 128)
# queries of one item of the persistent tensor-core kernels: three
# consumer warpgroups of 64 rows at D 64, two at D 128 causal
FWD_TC64_BLOCK = 192
FWD_TC128_BLOCK = 128
FWD_ITEM_QUERIES = {"wgmma64": FWD_TC64_BLOCK,
                    "wgmma128_causal": FWD_TC128_BLOCK}
# the seeded form's head dims: ardit-causal-forcing's 96, ardit-self-
# forcing's 128
SEEDED_HEAD_DIMS = (96, 128)


def kernel_path(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel that takes q/k/v of ``dtype`` at ``head_dim``:
    ``"wgmma"`` for bf16 at D 64, 96 or 128 (tensor cores, P rounded to bf16
    before P V as in SDPA), else ``"cuda_cores"`` (fp32 FMAs: fp32 inputs
    keep their 1e-4 agreement with the CPU, which TF32 would not; bf16
    at D 16 occurs only in tests)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_cores"


def fwd_instance(dtype: torch.dtype, head_dim: int, causal: bool,
                 window: int, sink: int, sparsity: float) -> str:
    """The forward kernel a call takes: ``"wgmma64"`` (bf16 at D 64, every
    mode: persistent, instantiated per mode), ``"wgmma128_causal"`` (bf16
    at D 128, causal without window, sink or rho: persistent),
    ``"wgmma"`` (the general tensor-core kernel: bf16 at D 96 and D 128's
    other modes) or ``"cuda_cores"`` (``kernel_path``'s rest)."""
    if kernel_path(dtype, head_dim) != "wgmma":
        return "cuda_cores"
    if head_dim == 64:
        return "wgmma64"
    if head_dim == 128 and causal and not window and not sink \
            and sparsity <= 0.0:
        return "wgmma128_causal"
    return "wgmma"


def seeded_path(dtype: torch.dtype, head_dim: int) -> str:
    """The path of ``paged_mha``'s in-chunk segment over CUDA tensors of
    ``dtype`` at ``head_dim``: ``"wgmma"`` (``flash_mha_seeded``, the
    tensor-core kernel's seeded form) for bf16 at D 96 or 128, else
    ``"plain"`` (``ref.flash_mha_seeded_ref`` on the card: fp32 keeps its
    1e-5 agreement with the CPU; the other head dims are the reduced
    configs').  ``flash_mha_seeded`` sends CPU tensors to the plain version
    whatever this says."""
    if dtype == torch.bfloat16 and head_dim in SEEDED_HEAD_DIMS:
        return "wgmma"
    return "plain"


def bwd_kernel_path(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel for q/k/v of ``dtype`` at ``head_dim``, by
    ``kernel_path``'s rule: ``"wgmma"`` for bf16 at D 64, 96 or 128 (P and
    dS rounded to bf16 for the tensor cores), else ``"cuda_cores"`` (fp32
    products: fp32 gradients keep their 1e-4 agreement with the CPU)."""
    return kernel_path(dtype, head_dim)


def keep_matrix(n_q: int, n_kv: int, *, causal: bool, q_offset: int,
                window: int, sink: int, sparsity: float,
                block_q: int, block_kv: int) -> np.ndarray:
    """Static [n_q, n_kv] 0/1 schedule for the rho knob (strided keep)
    — a copy of the reference's ``flash_attention/kernel.py``
    ``keep_matrix``."""
    keep = np.ones((n_q, n_kv), np.int32)
    if sparsity <= 0.0:
        return keep
    from repro_torch.models.attention import sparse_keep_list
    sink_blocks = max(1, sink // block_kv) if sink else 1
    for i in range(n_q):
        if causal:
            q_hi = q_offset + (i + 1) * block_q
            n_vis = min(n_kv, (q_hi + block_kv - 1) // block_kv)
        else:
            n_vis = n_kv
        kept = sparse_keep_list(1, [n_vis], sparsity,
                                sink_blocks=sink_blocks)[0]
        row = np.zeros((n_kv,), np.int32)
        row[list(kept)] = 1
        row[n_vis:] = 1          # blocks beyond visibility: causal pred cuts
        keep[i] = row
    return keep


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    if lib.flash_mha_launch.argtypes is None:
        # the tensor-core entry also takes the causal instance's counter
        for fn, n_int, n_ptr in ((lib.flash_mha_launch, 14, 1),
                                 (lib.flash_mha_wgmma_launch, 15, 2)):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n_int \
                + [ctypes.c_void_p] * n_ptr
            fn.restype = ctypes.c_int
        lib.flash_mha_seeded_launch.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_int] \
            + [ctypes.c_void_p] * 2
        lib.flash_mha_seeded_launch.restype = ctypes.c_int
        lib.flash_mha_error_string.argtypes = [ctypes.c_int]
        lib.flash_mha_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(BWD_SOURCE)
    if lib.flash_mha_bwd_launch.argtypes is None:
        lib.flash_mha_bwd_launch.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_int] * 14 + [ctypes.c_void_p]
        lib.flash_mha_bwd_launch.restype = ctypes.c_int
        lib.flash_mha_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_mha_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_tc_lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(BWD_TC_SOURCE)
    if lib.flash_mha_bwd_wgmma_launch.argtypes is None:
        lib.flash_mha_bwd_wgmma_launch.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_int] * 15 + [ctypes.c_void_p]
        lib.flash_mha_bwd_wgmma_launch.restype = ctypes.c_int
        lib.flash_mha_bwd_wgmma_error_string.argtypes = [ctypes.c_int]
        lib.flash_mha_bwd_wgmma_error_string.restype = ctypes.c_char_p
    return lib


def fwd_blocks(b: int, sq: int, hq: int, n_sm: int,
               item_queries: int = FWD_TC64_BLOCK) -> int:
    """Persistent blocks of a persistent tensor-core forward: one per SM
    (``n_sm``), never more than its items (``item_queries`` queries of
    one (b, head) each)."""
    return max(1, min(b * hq * -(-sq // item_queries), n_sm))


def fwd_item(r: int, b: int, sq: int, hq: int, causal: bool,
             item_queries: int = FWD_TC64_BLOCK,
             hkv: int = 0) -> Tuple[int, int, int]:
    """Rank ``r``'s (query tile, head, batch row) among the items of
    ``item_queries`` queries of one (b, head) (``item_of`` in
    ``csrc/flash_mha.cu``).  Non-causal items cost the same and rank with
    the query tile fastest, then the head, then the batch row, so the items
    in flight share a (b, KV head)'s K/V in L2; causal items rank by query
    tile, the last (heaviest) first, then head and batch row.  With
    ``hkv`` (the D 128 causal instance, ``d128::item_of``) causal items
    rank by (batch row, KV head), then query tile, heaviest first, then
    the head within its group of ``hq // hkv``, so the items in flight
    read one or two K/V prefixes and a group's heads at one query tile are
    neighbours."""
    n_qt = -(-sq // item_queries)
    if causal and hkv:
        g = hq // hkv
        t, bhk = r // g, r // g // n_qt
        return n_qt - 1 - t % n_qt, bhk % hkv * g + r % g, bhk // hkv
    if causal:
        qt, hb = n_qt - 1 - r // (b * hq), r % (b * hq)
    else:
        qt, hb = r % n_qt, r // n_qt
    return qt, hb % hq, hb // hq


def fwd_items(block: int, n_blocks: int, b: int, sq: int, hq: int,
              causal: bool, item_queries: int = FWD_TC64_BLOCK
              ) -> List[Tuple[int, int, int]]:
    """The items that persistent block ``block`` of ``n_blocks`` computes
    in the D 64 instance, in its order (``item_rank`` in
    ``csrc/flash_mha.cu``): ranks (``fwd_item``) are dealt in snake
    order, round m giving block j rank m n_blocks + j (m even) or m
    n_blocks + n_blocks - 1 - j (m odd), so that where ranks fall in cost
    each block's sum of work evens out.  (The D 128 causal instance's
    blocks take ranks in ``fwd_item`` order as they come free, from an
    atomic counter.)"""
    n_items = b * hq * -(-sq // item_queries)
    items = []
    for m in range(-(-n_items // n_blocks)):
        r = m * n_blocks + (n_blocks - 1 - block if m % 2 else block)
        if r >= n_items:
            break
        items.append(fwd_item(r, b, sq, hq, causal, item_queries))
    return items


def bwd_blocks(b: int, sq: int, skv: int, hq: int, hkv: int,
               path: str = "cuda_cores") -> Tuple[int, int]:
    """Blocks of the backward's (dK/dV, dQ) launches on ``path``."""
    blk = BWD_TC_BLOCK if path == "wgmma" else BWD_BLOCK
    return (b * hkv * -(-skv // blk), b * hq * -(-sq // blk))


def _check_mode(sq: int, skv: int, causal: bool, window: int, sink: int,
                sparsity: float, block_q: int, block_kv: int) -> None:
    if sparsity <= 0.0:
        return
    if not causal or window or sink or sq <= 1:
        raise ValueError(
            "rho block sparsity applies to the causal schedule without a "
            f"window or sink and Sq > 1 (causal={causal}, window={window},"
            f" sink={sink}, Sq={sq})")
    if sq % block_q or skv % block_kv:
        raise ValueError(
            f"rho block sparsity needs Sq {sq} and Skv {skv} to divide "
            f"into blocks of {block_q} x {block_kv}")


def _check(q, k, v, n_kv_heads):
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: one "
                        "of float32 or bfloat16 for all three")
    if d not in _HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape \
            or k.shape[0] != b or hkv != n_kv_heads or hq % hkv:
        raise ValueError(f"head dims / shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} "
                         f"(n_kv_heads {n_kv_heads}; D in {_HEAD_DIMS})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def _keep(sq, skv, causal, q_offset, window, sink, sparsity, block_q,
          block_kv, dev) -> Optional[torch.Tensor]:
    if sparsity <= 0.0:
        return None
    return torch.as_tensor(keep_matrix(
        sq // block_q, skv // block_kv, causal=causal, q_offset=q_offset,
        window=window, sink=sink, sparsity=sparsity, block_q=block_q,
        block_kv=block_kv)).to(dev)


def _launch(q, k, v, n_kv_heads, causal, q_offset, window, sink, sparsity,
            block_q, block_kv, with_lse=False):
    """The forward kernel; with ``with_lse`` returns (out, lse [B,Hq,Sq]
    fp32) for the backward."""
    _check(q, k, v, n_kv_heads)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dev = q.device
    keep = _keep(sq, skv, causal, q_offset, window, sink, sparsity,
                 block_q, block_kv, dev)
    out = torch.empty_like(q)
    lse = None
    if with_lse:
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        if skv == 0:                   # every row sees nothing
            lse.fill_(-float("inf"))
    lib = _lib()
    inst = fwd_instance(q.dtype, d, causal, window, sink, sparsity)
    tc = inst != "cuda_cores"
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if keep is None else keep.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, sq, skv, hq, hkv, d, int(causal), q_offset, window, sink,
            block_q, block_kv, 0 if keep is None else keep.shape[1],
            _DTYPES[q.dtype]]
    if tc:
        launch = lib.flash_mha_wgmma_launch
        # the persistent grid (0 takes the general kernel) and the D 128
        # causal instance's item counter, zeroed
        item = FWD_ITEM_QUERIES.get(inst)
        sched = torch.zeros(1, dtype=torch.int32, device=dev) \
            if inst == "wgmma128_causal" else None
        args += [fwd_blocks(b, sq, hq, _sm_count(dev), item) if item else 0,
                 None if sched is None else sched.data_ptr()]
    else:
        launch = lib.flash_mha_launch
    with torch.cuda.device(dev):        # the runtime launches on its device
        err = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.flash_mha_error_string(err).decode()
        raise RuntimeError(f"flash_mha launch failed: {msg}")
    flash_mha.launches += 1
    flash_mha.launches_tc += int(tc)
    flash_mha.launches_d128_causal += int(inst == "wgmma128_causal")
    return (out, lse) if with_lse else out


def _launch_seeded(q, k, v, m, l, acc, n_kv_heads):
    """The seeded form's launch: checks, output, item counter, grid."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dev = q.device
    for name, t in (("k", k), ("v", v), ("m", m), ("l", l), ("acc", acc)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_mha_seeded: no kernel for q/k/v "
                        f"{q.dtype}/{k.dtype}/{v.dtype} (one dtype)")
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape \
            or hkv != n_kv_heads or hq % hkv or skv < 1:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} (n_kv_heads {n_kv_heads})")
    part = (b, hkv, hq // hkv, sq)
    for name, t, shape in (("m", m, part), ("l", l, part),
                           ("acc", acc, part + (d,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    # k and v may be head-range views [..., lo:hi, :] of a wider tensor
    # (elastic SP2): read through their position stride, heads and D
    # dense, 16-byte strides for TMA
    ss = k.stride(1)
    if not q.is_contiguous() or v.stride() != k.stride() \
            or k.stride(3) != 1 or k.stride(2) != d or ss % 8 \
            or k.stride(0) != skv * ss:
        raise ValueError(f"q must be contiguous, k and v [B,S,H,D] with "
                         f"dense heads and D (strides {k.stride()}, "
                         f"{v.stride()})")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v are read by TMA: 16-byte aligned")
    out = torch.empty_like(q)
    sched = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):        # the runtime launches on its device
        err = lib.flash_mha_seeded_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(), out.data_ptr(), b, sq, skv, hq,
            hkv, d, ss, fwd_blocks(b, sq, hq, _sm_count(dev),
                                   FWD_TC128_BLOCK),
            sched.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.flash_mha_error_string(err).decode()
        raise RuntimeError(f"flash_mha_seeded launch failed: {msg}")
    flash_mha.launches_seeded += 1
    return out


def flash_mha_seeded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, *,
                     n_kv_heads: int) -> torch.Tensor:
    """q [B,Sq,Hq,D] attends to k, v [B,Skv,Hkv,D] (Skv >= 1), every key
    visible, each row's online softmax continuing from its partial m, l
    [B,Hkv,G,Sq] and acc [B,Hkv,G,Sq,D] (fp32, m in natural units, acc
    unnormalized: ``paged_chunk_attention``'s outputs; m = -1e30, l = 0
    for a row that saw nothing) -> [B,Sq,Hq,D] in q's dtype, 0 for a row
    whose l stays 0.  CUDA tensors that ``seeded_path`` sends to the
    kernel (bf16 at D 96 or 128) take the seeded form of the tensor-core
    kernel; CPU tensors and the rest take ``ref.flash_mha_seeded_ref``
    (counted in ``flash_mha.plain_segments``).  k and v may be head-range
    views of wider tensors; P enters P V in bf16, as in kernel 1 and
    SDPA."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_mha_seeded: no kernel for device "
                         f"{q.device}")
    if q.device.type == "cpu" or seeded_path(q.dtype, q.shape[-1]) \
            == "plain":
        flash_mha.plain_segments += 1
        return _ref.flash_mha_seeded_ref(q, k, v, m, l, acc,
                                         n_kv_heads=n_kv_heads)
    no_grad_through("flash_mha_seeded", q, k, v, m, l, acc)
    return _launch_seeded(q, k, v, m, l, acc, n_kv_heads)


def flash_mha_bwd(q, k, v, o, lse, dout, *, n_kv_heads, causal=True,
                  q_offset=0, window=0, sink=0, sparsity=0.0, block_q=128,
                  block_kv=128, path=None):
    """The backward kernel on CUDA tensors (every argument contiguous,
    q/k/v/o/dout of one dtype, lse fp32 [B,Hq,Sq] from the forward
    kernel): (dq, dk, dv).  The mode arguments are the forward's, with
    the block sizes as ``flash_mha`` clipped them.  ``path`` (default
    ``bwd_kernel_path``) may name ``"cuda_cores"`` where the tensor cores
    would run, to time or check that kernel; ``"wgmma"`` elsewhere
    raises."""
    _check(q, k, v, n_kv_heads)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dev = q.device
    auto = bwd_kernel_path(q.dtype, d)
    path = path or auto
    if path not in ("wgmma", "cuda_cores") or (path == "wgmma"
                                               and auto != "wgmma"):
        raise ValueError(f"flash_mha_bwd: no {path!r} kernel for "
                         f"{q.dtype} at D {d}")
    for name, t in (("o", o), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous like q")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or lse.device != dev or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 [B,Hq,Sq] on {dev}")
    keep = _keep(sq, skv, causal, q_offset, window, sink, sparsity,
                 block_q, block_kv, dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(),
            None if keep is None else keep.data_ptr()]
    mode = [b, sq, skv, hq, hkv, d, int(causal), q_offset, window, sink,
            block_q, block_kv, 0 if keep is None else keep.shape[1]]
    tc = path == "wgmma"
    if tc:
        # lse log2(e) and delta, rows padded to whole dQ blocks
        sq_pad = -(-sq // BWD_TC_BLOCK) * BWD_TC_BLOCK
        scratch = torch.empty((2, b, hq, sq_pad), dtype=torch.float32,
                              device=dev)
        lib = _bwd_tc_lib()
        launch, errors = (lib.flash_mha_bwd_wgmma_launch,
                          lib.flash_mha_bwd_wgmma_error_string)
        mode.append(sq_pad)
    else:
        scratch = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        lib = _bwd_lib()
        launch, errors = (lib.flash_mha_bwd_launch,
                          lib.flash_mha_bwd_error_string)
    with torch.cuda.device(dev):
        err = launch(*args, scratch.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), *mode, _DTYPES[q.dtype],
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = errors(err).decode()
        raise RuntimeError(f"flash_mha backward launch failed: {msg}")
    flash_mha.launches_bwd += 1
    flash_mha.launches_bwd_tc += int(tc)
    return dq, dk, dv


class FlashMHA(torch.autograd.Function):
    """``flash_mha`` with a gradient: the forward kernel writing each
    row's log-sum-exp and the backward kernel on CUDA tensors; the plain
    ``flash_mha_ref(return_lse=True)`` and ``flash_mha_bwd_ref`` on CPU
    tensors.  Saves q, k, v, the output and lse; the mode arguments get
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, n_kv_heads, causal, q_offset, window, sink,
                sparsity, block_q, block_kv):
        mode = dict(n_kv_heads=n_kv_heads, causal=causal,
                    q_offset=q_offset, window=window, sink=sink,
                    sparsity=sparsity, block_q=block_q, block_kv=block_kv)
        if q.device.type == "cpu":
            out, lse = _ref.flash_mha_ref(q, k, v, return_lse=True, **mode)
        else:
            out, lse = _launch(q, k, v, n_kv_heads, causal, q_offset, window,
                               sink, sparsity, block_q, block_kv,
                               with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mode = mode
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        bwd = _ref.flash_mha_bwd_ref if q.device.type == "cpu" \
            else flash_mha_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout, **ctx.mode)
        return (dq, dk, dv) + (None,) * 8


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              n_kv_heads: int, causal: bool = True, q_offset: int = 0,
              window: int = 0, sink: int = 0, sparsity: float = 0.0,
              block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """q [B,Sq,Hq,D]; k,v [B,Skv,Hkv,D] -> [B,Sq,Hq,D] in q's dtype.

    ``window``/``sink`` apply to causal attention only; rows that see
    nothing return 0.  ``block_q``/``block_kv`` (clipped to the lengths)
    are the granularity of the rho keep matrix."""
    sq, skv = q.shape[1], k.shape[1]
    q_offset, window, sink = int(q_offset), int(window), int(sink)
    block_q, block_kv = min(block_q, sq), min(block_kv, skv)
    _check_mode(sq, skv, causal, window, sink, sparsity, block_q, block_kv)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_mha: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashMHA.apply(q, k, v, n_kv_heads, causal, q_offset, window,
                              sink, sparsity, block_q, block_kv)
    if q.device.type == "cpu":
        return _ref.flash_mha_ref(
            q, k, v, n_kv_heads=n_kv_heads, causal=causal,
            q_offset=q_offset, window=window, sink=sink, sparsity=sparsity,
            block_q=block_q, block_kv=block_kv)
    return _launch(q, k, v, n_kv_heads, causal, q_offset, window, sink,
                   sparsity, block_q, block_kv)


flash_mha.launches = 0
flash_mha.launches_tc = 0
flash_mha.launches_d128_causal = 0
flash_mha.launches_seeded = 0
flash_mha.plain_segments = 0
flash_mha.launches_bwd = 0
flash_mha.launches_bwd_tc = 0
