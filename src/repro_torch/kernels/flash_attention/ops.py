"""Wrapper of the flash-attention kernel, in the model layout
[B, S, H, D].

A CPU tensor takes the plain PyTorch version (``ref.flash_mha_ref``,
the plain ``mha`` body); a CUDA tensor launches a hand-written CUDA
kernel of ``csrc/flash_mha.cu`` (built with nvcc at first use) or
raises.  There is no fallback between the two.  ``kernel_path`` picks
the kernel from the dtype and head dim alone: bf16 at D 96 or 128 runs
on the tensor cores (wgmma fed by TMA), everything else on the CUDA
cores.  ``flash_mha.launches`` counts kernel launches and
``flash_mha.launches_tc`` the tensor-core ones among them.

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

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_mha.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the configs' head dims: reduced 16, ardit-causal-forcing 96,
# ardit-self-forcing 128
_HEAD_DIMS = (16, 96, 128)
# the head dims of the tensor-core kernel (every full-width model)
WGMMA_HEAD_DIMS = (96, 128)


def kernel_path(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel that takes q/k/v of ``dtype`` at ``head_dim``:
    ``"wgmma"`` for bf16 at D 96 or 128 (tensor cores, P rounded to bf16
    before P V as in SDPA), else ``"cuda_cores"`` (fp32 FMAs: fp32 inputs
    keep their 1e-4 agreement with the CPU, which TF32 would not; bf16
    at D 16 occurs only in tests)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_cores"


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
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.flash_mha_error_string.argtypes = [ctypes.c_int]
        lib.flash_mha_error_string.restype = ctypes.c_char_p
    return lib


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


def _launch(q, k, v, n_kv_heads, causal, q_offset, window, sink, sparsity,
            block_q, block_kv):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
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
    keep = None
    if sparsity > 0.0:
        keep = torch.as_tensor(keep_matrix(
            sq // block_q, skv // block_kv, causal=causal,
            q_offset=q_offset, window=window, sink=sink, sparsity=sparsity,
            block_q=block_q, block_kv=block_kv)).to(dev)
    out = torch.empty_like(q)
    lib = _lib()
    tc = kernel_path(q.dtype, d) == "wgmma"
    launch = lib.flash_mha_wgmma_launch if tc else lib.flash_mha_launch
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if keep is None else keep.data_ptr(), out.data_ptr(),
        b, sq, skv, hq, hkv, d, int(causal), q_offset, window, sink,
        block_q, block_kv, 0 if keep is None else keep.shape[1],
        _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.flash_mha_error_string(err).decode()
        raise RuntimeError(f"flash_mha launch failed: {msg}")
    flash_mha.launches += 1
    flash_mha.launches_tc += int(tc)
    return out


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
    if q.device.type == "cpu":
        return _ref.flash_mha_ref(
            q, k, v, n_kv_heads=n_kv_heads, causal=causal,
            q_offset=q_offset, window=window, sink=sink, sparsity=sparsity,
            block_q=block_q, block_kv=block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: no kernel for device {q.device}")
    return _launch(q, k, v, n_kv_heads, causal, q_offset, window, sink,
                   sparsity, block_q, block_kv)


flash_mha.launches = 0
flash_mha.launches_tc = 0
