"""Hand-written Hopper kernels (CUDA C++ for sm_90a).

Each subpackage is <name>/{csrc/*.cu (the kernel), ref.py (its plain
PyTorch version), ops.py (the wrapper: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise)}.  ``build.py``
compiles a ``csrc`` source with nvcc into a shared library at first
use and loads it with ctypes.

    paged_attention   chunk-query attention partials over the paged KV
                      pool (the batched serving executor's hot path)
    flash_attention   blocked attention with the fidelity knobs: every
                      ``models.attention.mha`` call without a per-row
                      mask (the sequential executor, the gather backend)
    ssd_scan          the Mamba-2 SSD chunked scan: every layer of the
                      SSM family's ``prefill`` / ``forward``
"""
