"""Wrapper of the Mamba-2 SSD chunked scan, in the model layout.

A CPU tensor takes the plain PyTorch version (``ref.ssd_ref``); a CUDA
tensor launches the hand-written CUDA kernel (``csrc/ssd_scan.cu``,
three passes, built with nvcc at first use) or raises.  There is no
fallback between the two.  ``ssd.launches`` counts kernel launches: one
per call on the card (the three passes together), so one per layer per
``prefill`` / ``forward``.  The one-token ``ssd_decode`` is the plain
recurrence on every device, as in the reference.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (head dim P, state N) pairs the kernel instantiates: mamba2-780m
# (64, 128) and its reduced config (16, 16)
_SHAPES = ((64, 128), (16, 16))
_MAX_CHUNK = 128


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
            + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, dt, A, Bm, Cm, chunk, init_state):
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    dev = x.device
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("init_state", init_state)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x/Bm/Cm dtypes {x.dtype}/{Bm.dtype}/{Cm.dtype}: "
                        "one of float32 or bfloat16 for all three")
    if g != 1:
        raise ValueError(f"the kernel folds n_groups to 1 (got G = {g})")
    if (p, n) not in _SHAPES:
        raise ValueError(f"(P, N) = ({p}, {n}) not in {_SHAPES}")
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or tuple(Cm.shape) != tuple(Bm.shape) \
            or tuple(Bm.shape[:2]) != (b, s):
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} Bm {tuple(Bm.shape)} "
                         f"Cm {tuple(Cm.shape)}")
    q = min(chunk, s)
    if not 0 < q <= _MAX_CHUNK:
        raise ValueError(
            f"chunk length {q}: the kernel takes 1-{_MAX_CHUNK}")
    # x, B and C are read in place: (h, p) and n contiguous, any batch
    # and token strides (the model passes slices of the conv output)
    if x.stride(3) != 1 or x.stride(2) != p or Bm.stride(3) != 1 \
            or Cm.stride(3) != 1:
        raise ValueError("x needs contiguous (H, P) rows and Bm/Cm "
                         "contiguous N")
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    if init_state is not None:
        if tuple(init_state.shape) != (b, h, p, n):
            raise ValueError(f"init_state {tuple(init_state.shape)}, "
                             f"expected {(b, h, p, n)}")
        init_state = init_state.float().contiguous()
    nc = -(-s // q)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    states = torch.empty((b, h, nc, p, n), dtype=torch.float32, device=dev)
    decay = torch.empty((b, h, nc), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), states.data_ptr(), decay.data_ptr(), final.data_ptr(),
        b, s, h, p, n, q, x.stride(0), x.stride(1), Bm.stride(0),
        Bm.stride(1), Cm.stride(0), Cm.stride(1), _DTYPES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan launch failed: {msg}")
    ssd.launches += 1
    return y, final


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
        init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P], dt [B,S,H], A [H], Bm/Cm [B,S,G,N], init_state
    [B,H,P,N] or None -> (y [B,S,H,P] in x's dtype, final state
    [B,H,P,N] fp32)."""
    if x.device.type == "cpu":
        return _ref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    return _launch(x, dt, A, Bm, Cm, chunk, init_state)


ssd.launches = 0


def ssd_decode(x, dt, A, Bm, Cm, state):
    return _ref.ssd_decode_ref(x, dt, A, Bm, Cm, state)
