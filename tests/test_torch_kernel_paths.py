"""Which hand-written CUDA kernel each wrapper picks, on the CPU.

``flash_attention.ops.kernel_path`` sends bf16 at head dims 96 and 128
(every full-width model) to the tensor-core kernel and fp32 (the reduced
configs, held to 1e-4 against the CPU) and bf16 at D 16 to the CUDA-core
kernel.  ``fp8_matmul.ops.kernel_path`` sends shapes whose K and N are
nonzero multiples of 16 (TMA's 16-byte row strides; both FFN shapes of
the chip check) to the tensor-core kernel, the rest (the reference
tests' K 136 and 40, N 300) to the CUDA-core kernel.  Both decide from
the inputs alone.
"""
import pytest
import torch

from repro_torch.configs.ardit_causal_forcing import CONFIG as CAUSAL
from repro_torch.configs.ardit_self_forcing import CONFIG as SELF
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fp8_matmul import ops as fp8_ops


@pytest.mark.parametrize("dtype,head_dim,path", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 96, "wgmma"),
    (torch.bfloat16, 16, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"),
    (torch.float32, 96, "cuda_cores"),
    (torch.float32, 16, "cuda_cores"),
])
def test_flash_path_by_dtype_and_head_dim(dtype, head_dim, path):
    assert flash_ops.kernel_path(dtype, head_dim) == path


@pytest.mark.parametrize("cfg", [SELF, CAUSAL], ids=["self", "causal"])
def test_full_width_models_take_the_tensor_cores(cfg):
    head_dim = cfg.d_model // cfg.n_heads
    assert flash_ops.kernel_path(torch.bfloat16, head_dim) == "wgmma"
    reduced = cfg.reduced()
    assert flash_ops.kernel_path(
        torch.float32, reduced.d_model // reduced.n_heads) == "cuda_cores"


@pytest.mark.parametrize("K,N,path", [
    (4096, 16384, "wgmma"),       # minitron-8b FFN up-projection
    (1536, 8960, "wgmma"),        # the AR-DiT's FFN
    (64, 64, "wgmma"), (256, 64, "wgmma"), (32, 32, "wgmma"),
    (16, 16, "wgmma"),
    (136, 264, "cuda_cores"),     # K % 16 == 8
    (40, 24, "cuda_cores"),       # K and N % 16 == 8
    (4096, 300, "cuda_cores"),    # N % 16 == 12
    (8, 64, "cuda_cores"),
    (0, 64, "cuda_cores"),        # nothing to sum
])
def test_fp8_path_by_shape(K, N, path):
    assert fp8_ops.kernel_path(K, N) == path


def test_cpu_tensors_take_the_plain_versions_whatever_the_path():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 2, 128), generator=g).bfloat16()
    before = (flash_ops.flash_mha.launches, flash_ops.flash_mha.launches_tc)
    out = flash_ops.flash_mha(q, q, q, n_kv_heads=2, causal=False)
    assert out.shape == q.shape and out.dtype == q.dtype
    x = torch.randn((16, 64), generator=g)
    w = torch.randn((64, 32), generator=g)
    b8 = (fp8_ops.fp8_scaled_matmul.launches,
          fp8_ops.fp8_scaled_matmul.launches_tc)
    assert fp8_ops.fp8_matmul(x, w).shape == (16, 32)
    assert (flash_ops.flash_mha.launches,
            flash_ops.flash_mha.launches_tc) == before
    assert (fp8_ops.fp8_scaled_matmul.launches,
            fp8_ops.fp8_scaled_matmul.launches_tc) == b8
