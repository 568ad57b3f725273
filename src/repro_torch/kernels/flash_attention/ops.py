"""Wrapper of the flash-attention kernel, in the model layout
[B, S, H, D].

A CPU tensor takes the plain PyTorch version (``ref.flash_mha_ref``,
the plain ``mha`` body); a CUDA tensor launches a hand-written CUDA
kernel of ``csrc/flash_mha.cu`` (built with nvcc at first use) or
raises.  There is no fallback between the two.  ``kernel_path`` picks
the kernel from the dtype and head dim alone: bf16 at D 64, 96 or 128
runs on the tensor cores (wgmma fed by TMA), everything else on the CUDA
cores.  ``flash_mha.launches`` counts kernel launches and
``flash_mha.launches_tc`` the tensor-core ones among them.

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
from typing import Optional, Tuple

import numpy as np
import torch

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


def kernel_path(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel that takes q/k/v of ``dtype`` at ``head_dim``:
    ``"wgmma"`` for bf16 at D 64, 96 or 128 (tensor cores, P rounded to bf16
    before P V as in SDPA), else ``"cuda_cores"`` (fp32 FMAs: fp32 inputs
    keep their 1e-4 agreement with the CPU, which TF32 would not; bf16
    at D 16 occurs only in tests)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_cores"


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
        for fn in (lib.flash_mha_launch, lib.flash_mha_wgmma_launch):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
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
    tc = kernel_path(q.dtype, d) == "wgmma"
    launch = lib.flash_mha_wgmma_launch if tc else lib.flash_mha_launch
    with torch.cuda.device(dev):        # the runtime launches on its device
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if keep is None else keep.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, sq, skv, hq, hkv, d, int(causal), q_offset, window, sink,
            block_q, block_kv, 0 if keep is None else keep.shape[1],
            _DTYPES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.flash_mha_error_string(err).decode()
        raise RuntimeError(f"flash_mha launch failed: {msg}")
    flash_mha.launches += 1
    flash_mha.launches_tc += int(tc)
    return (out, lse) if with_lse else out


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
flash_mha.launches_bwd = 0
flash_mha.launches_bwd_tc = 0
