"""Plain PyTorch version of the Mamba-2 SSD (state-space duality) chunked
scan, a port of the JAX reference's ``kernels/ssd_scan/ref.py``.

Semantics (Mamba-2, arXiv:2405.21060 SS6): the selective SSM
    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t x_t^T
    y_t = C_t . h_t
is evaluated in chunks of length ``Q``: quadratic attention-like math inside
a chunk, linear recurrence across chunk boundaries.

Shapes (G = n_groups divides H = n_heads):
    x  [B, S, H, P]     dt [B, S, H] (post-softplus, >= 0)
    A  [H] (negative)   Bm [B, S, G, N]   Cm [B, S, G, N]
    init_state [B, H, P, N] or None
Returns  (y [B, S, H, P], final_state [B, H, P, N]), all fp32 accumulation.

The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel
(``csrc/ssd_scan.cu``) against it on the card.  ``ssd_decode_ref`` (the
one-token recurrence) is the only version of the decode step, on every
device, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, *,
            chunk: int = 128,
            init_state: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    assert h % g == 0, (h, g)
    out_dtype = x.dtype

    # pad sequence to a multiple of the chunk length
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // q

    xf = x.float().reshape(b, nc, q, h, p)
    dtf = dt.float().reshape(b, nc, q, h)
    Bf = Bm.float().reshape(b, nc, q, g, n)
    Cf = Cm.float().reshape(b, nc, q, g, n)
    rep = h // g
    Bh = Bf.repeat_interleave(rep, dim=3)                # [B,nc,Q,H,N]
    Ch = Cf.repeat_interleave(rep, dim=3)

    dA = dtf * A.float()                                 # [B,nc,Q,H] (<= 0)
    cs = torch.cumsum(dA, dim=2)                         # inclusive cumsum

    # ---- intra-chunk (quadratic, masked) -----------------------------------
    # L[i,j] = exp(cs_i - cs_j) for i >= j else 0
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # [B,nc,Qi,Qj,H]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    L = torch.where(mask[None, None, :, :, None], torch.exp(seg),
                    torch.zeros((), device=x.device))
    del seg
    CB = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    W = CB * L * dtf[:, :, None, :, :]                   # weight on x_j
    del CB, L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xf)
    del W

    # ---- per-chunk state contribution --------------------------------------
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)      # [B,nc,Q,H]
    chunk_states = torch.einsum("bcjhn,bcjhp->bchpn",
                                Bh * (dtf * decay_to_end)[..., None], xf)
    chunk_decay = torch.exp(cs[:, :, -1, :])             # [B,nc,H]

    # ---- inter-chunk recurrence (the reference's scan over chunks) ---------
    if init_state is None:
        state = torch.zeros((b, h, p, n), dtype=torch.float32,
                            device=x.device)
    else:
        state = init_state.float()
    entering = []
    for c in range(nc):
        entering.append(state)                           # state before chunk
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    entering_states = torch.stack(entering, dim=1)       # [B,nc,H,P,N]
    del entering, chunk_states

    # ---- inter-chunk output -------------------------------------------------
    c_weight = Ch * torch.exp(cs)[..., None]             # [B,nc,Q,H,N]
    y_inter = torch.einsum("bcihn,bchpn->bcihp", c_weight, entering_states)

    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s]
    return y.to(out_dtype), state


def ssd_decode_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent update.

    x [B,H,P], dt [B,H], Bm/Cm [B,G,N], state [B,H,P,N].
    Returns (y [B,H,P], new_state).
    """
    b, h, p = x.shape
    g, n = Bm.shape[1], Bm.shape[2]
    rep = h // g
    Bh = Bm.float().repeat_interleave(rep, dim=1)          # [B,H,N]
    Ch = Cm.float().repeat_interleave(rep, dim=1)
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())                        # [B,H]
    xdt = x.float() * dtf[..., None]                       # [B,H,P]
    new_state = (state.float() * dA[:, :, None, None]
                 + xdt[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _operand(t: torch.Tensor, pair: bool) -> torch.Tensor:
    """An fp32 operand as the tensor cores take it: one bf16 rounding,
    or a bf16 hi + lo pair (two products, ~16 significant bits)."""
    hi = _bf16(t)
    return hi + _bf16(t - hi) if pair else hi


# The fp32 operands of the tensor-core SSD kernel (csrc/ssd_scan.cu,
# ``ssd_wgmma_kernel``) that go to the tensor cores as a bf16 hi + lo
# pair; the others take one bf16 rounding.  W = (C B^T) o L o dt (the
# intra-chunk weights), XW = (x o dt o exp(cs_last - cs)) (the chunk
# state's operand) and the entering state of the inter-chunk output.
# Settled on the CPU against JAX's ssd_pallas (tests/test_torch_ssd.py
# measures it): with XW single the final state is off by ~2e-3 of its
# magnitude (limit 1e-4), so XW is a pair (4e-6); W and the state as
# single roundings leave y within 1 of the 2 bf16 ulps allowed (0.25 as
# pairs), so they take one rounding each.
KERNEL_PAIRS = frozenset({"xw"})


def ssd_kernel_emulation(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor, *,
                         chunk: int = 128,
                         init_state: Optional[torch.Tensor] = None,
                         pairs=KERNEL_PAIRS,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan as the tensor-core kernel factors and rounds it
    (tests only; G = 1): per chunk, CB = C B^T once for all heads (bf16
    inputs, exact products summed in fp32); per head W = CB o L o dt_j
    (L = exp(cs_i - cs_j) only where i >= j), y_intra = W X; the chunk
    state contrib = (X o w)^T B with w_j = dt_j exp(cs_last - cs_j); the
    state chained chunk after chunk as state * exp(cs_last) + contrib,
    in fp32; y_inter = exp(cs_i) (C state^T).  Each fp32 operand is
    rounded as the kernel feeds it (``pairs`` names those fed as a hi +
    lo pair, the rest are single bf16 roundings); x, B and C are the
    inputs' own values.  Same contract as ``ssd_ref``."""
    b, s, h, p = x.shape
    n = Bm.shape[3]
    assert Bm.shape[2] == 1, "the kernel folds n_groups to 1"
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float()[:, :, 0], Cm.float()[:, :, 0]
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        xc, dtc = xf[:, sl], dtf[:, sl]                  # [b,q,h,p], [b,q,h]
        Bc, Cc = Bf[:, sl], Cf[:, sl]                    # [b,q,n]
        cs = torch.cumsum(dtc * A.float(), dim=1)        # [b,q,h]
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)        # once per chunk
        seg = cs[:, :, None, :] - cs[:, None, :, :]      # [b,i,j,h]
        L = torch.where(tri[None, :, :, None], torch.exp(seg),
                        torch.zeros((), device=x.device))
        W = cb[..., None] * L * dtc[:, None, :, :]       # [b,i,j,h]
        y = torch.einsum("bijh,bjhp->bihp", _operand(W, "w" in pairs), xc)
        wj = dtc * torch.exp(cs[:, -1:, :] - cs)         # [b,q,h]
        xw = _operand(xc * wj[..., None], "xw" in pairs)
        contrib = torch.einsum("bjhp,bjn->bhpn", xw, Bc)
        st = _operand(state, "state" in pairs)
        y = y + torch.exp(cs)[..., None] * torch.einsum("bin,bhpn->bihp",
                                                        Cc, st)
        ys.append(y)
        state = state * torch.exp(cs[:, -1, :])[:, :, None, None] + contrib
    y = torch.cat(ys, 1)[:, :s]
    return y.to(x.dtype), state
