"""Wrappers of the scaled fp8 matmul.

``quantize_fp8`` is plain PyTorch on every device, as the reference runs
its oracle on every backend.  ``fp8_scaled_matmul`` takes quantized
operands: a CPU tensor takes the plain version (``ref.fp8_matmul_ref``),
a CUDA tensor launches a hand-written CUDA kernel of
``csrc/fp8_matmul.cu`` (built with nvcc at first use) or raises; there
is no fallback between the two.  ``kernel_path`` picks the kernel from
the shape alone: K and N multiples of 16 run on the tensor cores (the
e4m3 operands, fed by TMA, widened to bf16 in shared memory and
multiplied on bf16 wgmma into fp32, partial sums promoted into fp32
registers every 64 of K), other shapes on the CUDA cores.
``fp8_scaled_matmul.launches`` counts kernel launches and
``fp8_scaled_matmul.launches_tc`` the tensor-core ones among them.
``fp8_matmul`` quantizes both operands online and calls it, as the
reference's ``fp8_matmul`` does.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.common.grad import no_grad_through
from repro_torch.kernels.fp8_matmul import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fp8_matmul.cu"

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_path(k: int, n: int) -> str:
    """The CUDA kernel for x_q [M,k] x w_q [k,n]: ``"wgmma"`` where k and
    n are nonzero multiples of 16 (TMA needs 16-byte row strides), else
    ``"cuda_cores"``."""
    if k > 0 and k % 16 == 0 and n % 16 == 0:
        return "wgmma"
    return "cuda_cores"


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.fp8_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        tc = lib.fp8_matmul_wgmma_launch
        tc.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        tc.restype = ctypes.c_int
        lib.fp8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.fp8_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x_q, w_q, sx, sw, out_dtype):
    m, k = x_q.shape
    k2, n = w_q.shape
    dev = x_q.device
    for name, t in (("w_q", w_q), ("sx", sx), ("sw", sw)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x_q on {dev}")
    if x_q.dtype != torch.float8_e4m3fn or w_q.dtype != torch.float8_e4m3fn:
        raise TypeError(f"operands {x_q.dtype}/{w_q.dtype}: float8_e4m3fn")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError(f"scales {sx.dtype}/{sw.dtype}: float32")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype {out_dtype}: float32 or bfloat16")
    if k != k2 or tuple(sx.shape) != (m, 1) or tuple(sw.shape) != (1, n):
        raise ValueError(f"shapes x_q {tuple(x_q.shape)}, w_q "
                         f"{tuple(w_q.shape)}, sx {tuple(sx.shape)}, sw "
                         f"{tuple(sw.shape)}")
    xq, wq = x_q.contiguous(), w_q.contiguous()
    sxc, swc = sx.contiguous(), sw.contiguous()
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("x_q and w_q must be 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tc = kernel_path(k, n) == "wgmma"
    launch = lib.fp8_matmul_wgmma_launch if tc else lib.fp8_matmul_launch
    with torch.cuda.device(dev):        # the runtime launches on its device
        err = launch(
            xq.data_ptr(), wq.data_ptr(), sxc.data_ptr(), swc.data_ptr(),
            out.data_ptr(), m, n, k, _OUT_DTYPES[out_dtype], stream)
    if err != 0:
        msg = lib.fp8_matmul_error_string(err).decode()
        raise RuntimeError(f"fp8_matmul launch failed: {msg}")
    fp8_scaled_matmul.launches += 1
    fp8_scaled_matmul.launches_tc += int(tc)
    return out


def quantize_fp8(x: torch.Tensor,
                 axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slice dynamic fp8-e4m3 quantization along ``axis``; see
    ``ref.quantize_fp8_ref``."""
    return _ref.quantize_fp8_ref(x, axis)


def fp8_scaled_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                      sx: torch.Tensor, sw: torch.Tensor, *,
                      out_dtype=torch.float32) -> torch.Tensor:
    """x_q [M,K] fp8, w_q [K,N] fp8, sx [M,1], sw [1,N] fp32 ->
    (x_q w_q) * sx * sw [M,N] in ``out_dtype`` (fp32 or bf16), summed in
    fp32 with both scales folded in once, at the end.  Any M, N, K."""
    if x_q.device.type == "cpu":
        return _ref.fp8_matmul_ref(x_q, w_q, sx, sw).to(out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"fp8_scaled_matmul: no kernel for device "
                         f"{x_q.device}")
    no_grad_through("fp8_scaled_matmul", x_q, w_q, sx, sw)
    return _launch(x_q, w_q, sx, sw, out_dtype)


fp8_scaled_matmul.launches = 0
fp8_scaled_matmul.launches_tc = 0


def fp8_matmul(x: torch.Tensor, w: torch.Tensor, *,
               out_dtype=torch.float32) -> torch.Tensor:
    """Online-quantized matmul: x [M,K] any float, w [K,N] any float;
    x per row and w per column into fp8-e4m3, then the scaled matmul."""
    x_q, sx = quantize_fp8(x, axis=1)
    w_q, sw = quantize_fp8(w, axis=0)
    return fp8_scaled_matmul(x_q, w_q, sx, sw, out_dtype=out_dtype)
