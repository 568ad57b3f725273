"""Wrapper of the Mamba-2 SSD chunked scan, in the model layout.

A CPU tensor takes the plain PyTorch version (``ref.ssd_ref``); a CUDA
tensor launches a hand-written CUDA kernel (``csrc/ssd_scan.cu``, built
with nvcc at first use) or raises.  There is no fallback between the
two.  ``kernel_path`` picks the kernel from the dtype, (P, N) and the
views' alignment alone: bf16 x/B/C at mamba2-780m's (64, 128) or
jamba-v0.1-52b's (64, 16) with 16-byte aligned views run on the tensor
cores (``"wgmma"``: one C B^T per chunk for a group of heads, the state
chained across chunks through L2; a kernel instance per N), the rest on
the CUDA cores (``"cuda_cores"``: three passes; fp32, the reduced
configs' (16, 16) and views TMA cannot read).
``ssd.launches`` counts kernel launches, one per call on the card, so
one per layer per ``prefill`` / ``forward``; ``ssd.launches_tc`` those on
the tensor cores.  The one-token ``ssd_decode`` is the plain
recurrence on every device, as in the reference.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.logical import per_shard
from repro_torch.kernels.common.grad import no_grad_through

from repro_torch.kernels.ssd_scan import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (head dim P, state N) pairs the kernel instantiates: mamba2-780m
# (64, 128), jamba-v0.1-52b (64, 16) and the reduced configs (16, 16)
_SHAPES = ((64, 128), (64, 16), (16, 16))
_MAX_CHUNK = 128
# the tensor-core kernel's (P, N) pairs
WGMMA_SHAPES = frozenset({(64, 128), (64, 16)})
# its (heads per block, blocks per SM at least) at each N: one build at
# N = 128; at N = 16 the fastest of (4, 1), (4, 2), (8, 1) and (8, 2) on
# an H100 (``launch/profile_ssd.py --state 16`` compares them)
TC_BLOCKING = {128: (6, 1), 16: (4, 2)}


def kernel_path(dtype: torch.dtype, head_dim: int, state_dim: int,
                aligned: bool = True) -> str:
    """The CUDA kernel that takes x/B/C of ``dtype`` at (P, N) =
    (``head_dim``, ``state_dim``): ``"wgmma"`` for bf16 at (64, 128) or
    (64, 16) whose views TMA can read (``aligned``: bases 16-byte
    aligned, batch and token strides multiples of 8 elements), else
    ``"cuda_cores"`` (fp32 keeps its 1e-4 agreement with the CPU; (16,
    16) is the reduced configs')."""
    if dtype == torch.bfloat16 and (head_dim, state_dim) in WGMMA_SHAPES \
            and aligned:
        return "wgmma"
    return "cuda_cores"


def _tma_aligned(*views: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
               and t.stride(1) % 8 == 0 for t in views)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
            + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        tc = lib.ssd_scan_wgmma_launch
        tc.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
            + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        tc.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, dt, A, Bm, Cm, chunk, init_state, path=None):
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
    auto = kernel_path(x.dtype, p, n, _tma_aligned(x, Bm, Cm))
    path = path or auto
    if path not in ("wgmma", "cuda_cores") or (path == "wgmma"
                                               and auto != "wgmma"):
        raise ValueError(f"ssd: no {path!r} kernel for {x.dtype} at "
                         f"(P, N) = ({p}, {n}) over these views")
    tc = path == "wgmma"
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    init = None if init_state is None else init_state.data_ptr()
    if tc:
        # two slots of the chained states, and the chain's flags (one per
        # (b, h) and warp, then the ticket counter), zeroed
        slots = torch.empty((2, b, h, p, n), dtype=torch.float32, device=dev)
        flags = torch.zeros((b * h * 8 + 1,), dtype=torch.int32, device=dev)
        err = lib.ssd_scan_wgmma_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), init, y.data_ptr(), final.data_ptr(),
            slots.data_ptr(), flags.data_ptr(), b, s, h, n, q,
            *TC_BLOCKING[n], x.stride(0),
            x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0),
            Cm.stride(1), stream)
    else:
        states = torch.empty((b, h, nc, p, n), dtype=torch.float32,
                             device=dev)
        decay = torch.empty((b, h, nc), dtype=torch.float32, device=dev)
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), init, y.data_ptr(), states.data_ptr(),
            decay.data_ptr(), final.data_ptr(), b, s, h, p, n, q,
            x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
            Cm.stride(0), Cm.stride(1), _DTYPES[x.dtype], stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan launch failed: {msg}")
    ssd.launches += 1
    ssd.launches_tc += int(tc)
    return y, final


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
        init_state: Optional[torch.Tensor] = None,
        path: Optional[str] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P], dt [B,S,H], A [H], Bm/Cm [B,S,G,N], init_state
    [B,H,P,N] or None -> (y [B,S,H,P] in x's dtype, final state
    [B,H,P,N] fp32).

    On DTensors (a sharded step) it runs on each shard's local heads
    and batch rows (``logical.per_shard``; B and C are split by group
    where the groups divide as the heads do), chosen by the local
    tensors' device.  ``path`` (on the card; default ``kernel_path``) may
    name ``"cuda_cores"`` where the tensor cores would run, to time or
    check those passes; ``"wgmma"`` elsewhere raises."""
    if isinstance(x, DTensor):
        g = Bm.shape[2]
        gd = 2 if g > 1 else None
        return per_shard(
            lambda *a: ssd(*a[:5], chunk=chunk, init_state=a[5],
                           path=path),
            (x, dt, A, Bm, Cm, init_state),
            ((0, 2), (0, 2), (None, 0), (0, gd), (0, gd), (0, 1)),
            ((0, 2), (0, 1)), batch=x.shape[0],
            heads=(x.shape[2],) + ((g,) if gd else ()))
    if x.device.type == "cpu":
        return _ref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    no_grad_through("ssd", x, dt, A, Bm, Cm, init_state)
    with torch.cuda.device(x.device):   # the runtime launches on its device
        return _launch(x, dt, A, Bm, Cm, chunk, init_state, path)


ssd.launches = 0
ssd.launches_tc = 0


def ssd_decode(x, dt, A, Bm, Cm, state):
    """One token's state update (plain on every device): x [B,H,P], dt
    [B,H], A [H], Bm/Cm [B,G,N], state [B,H,P,N].  On DTensors, per
    shard of batch rows and heads, as ``ssd``."""
    if isinstance(x, DTensor):
        g = Bm.shape[1]
        gd = 1 if g > 1 else None
        return per_shard(
            ssd_decode, (x, dt, A, Bm, Cm, state),
            ((0, 1), (0, 1), (None, 0), (0, gd), (0, gd), (0, 1)),
            ((0, 1), (0, 1)), batch=x.shape[0],
            heads=(x.shape[1],) + ((g,) if gd else ()))
    return _ref.ssd_decode_ref(x, dt, A, Bm, Cm, state)
