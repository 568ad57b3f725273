"""Hand-written Hopper kernels (CUDA C++ for sm_90a), one for every TPU
kernel of the reference package.

Each subpackage is <name>/{csrc/*.cu (the kernels), ref.py (their plain
PyTorch versions), ops.py (the wrappers: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise)}.  ``build.py``
compiles a ``csrc`` source with nvcc into a shared library at first
use and loads it with ctypes.

    paged_attention   chunk-query attention partials over the paged KV
                      pool (the batched serving executor's hot path,
                      also per KV-head range for elastic SP2) and
                      one-token decode with per-stream lengths
                      (``paged_decode_attention``)
    flash_attention   blocked attention with the fidelity knobs: every
                      ``models.attention.mha`` call without a per-row
                      mask (the sequential executor, the gather backend)
    ssd_scan          the Mamba-2 SSD chunked scan: every layer of the
                      SSM family's ``prefill`` / ``forward``
    fp8_matmul        the online-quantized scaled fp8 matmul (knob Q):
                      ``quantize_fp8`` (plain on every device) and
                      ``fp8_matmul``
"""
from repro_torch.kernels.fp8_matmul.ops import (  # noqa: F401
    fp8_matmul, quantize_fp8)
