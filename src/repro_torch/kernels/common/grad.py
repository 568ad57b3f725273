"""The autograd guard of the kernel wrappers whose kernels have no
backward.

A wrapper fills its outputs through ctypes, so on the card they carry no
``grad_fn``: a ``backward()`` through them would quietly leave the
kernel's share out of every upstream gradient.  The reference's TPU
kernels have no VJP either, and differentiating through one fails there;
so here the wrapper raises before it launches, until its kernel gets a
backward (the flash kernel has one: ``flash_attention.ops.FlashMHA``).
"""
from __future__ import annotations

import torch

# ROADMAP section 2 queues the backward kernels
_ITEM = "ROADMAP section 2, 'TPU kernels to port': backward kernels"


def no_grad_through(name: str, *tensors) -> None:
    """Raise when grad mode is on and any tensor of ``tensors`` requires
    grad: the kernel ``name`` has no backward yet.  Silent under
    ``torch.no_grad()`` and for inputs that need no gradient."""
    if not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet, so a gradient "
            f"through it would be lost; call it under torch.no_grad() or "
            f"on inputs that need no gradient ({_ITEM}: {name})")
