"""Which hand-written CUDA kernel each wrapper picks, on the CPU.

``flash_attention.ops.kernel_path`` sends bf16 at head dims 96 and 128
(every full-width model) to the tensor-core kernel and fp32 (the reduced
configs, held to 1e-4 against the CPU) and bf16 at D 16 to the CUDA-core
kernel.  ``fp8_matmul.ops.kernel_path`` sends shapes whose K and N are
nonzero multiples of 16 (TMA's 16-byte row strides; both FFN shapes of
the chip check) to the tensor-core kernel, the rest (the reference
tests' K 136 and 40, N 300) to the CUDA-core kernel.
``paged_attention.ops.kernel_path`` sends bf16 chunk queries over bf16
or e4m3 pages at D 96 and 128 with a group dividing 128 (every
full-width AR-DiT config) to the tensor-core kernel, and fp32 queries or
pages (the reduced configs), D 16 and bf16 queries over fp32 pages to
the CUDA-core kernel; ``decode_dtypes_supported`` is the decode kernel's
dtype gate: q fp32 or bf16 over pages of fp32, bf16 or e4m3, any mix,
as the reference widens all three to fp32.  All decide from the inputs
alone.
"""
import pytest
import torch

from repro_torch.configs.ardit_causal_forcing import CONFIG as CAUSAL
from repro_torch.configs.ardit_self_forcing import CONFIG as SELF
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fp8_matmul import ops as fp8_ops
from repro_torch.kernels.paged_attention import ops as paged_ops


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


BF16, F32, E4M3 = torch.bfloat16, torch.float32, torch.float8_e4m3fn


@pytest.mark.parametrize("group", [1, 2, 4, 8, 3, 6, 256])
@pytest.mark.parametrize("head_dim", [16, 96, 128])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (BF16, BF16), (BF16, E4M3), (BF16, F32), (F32, F32), (F32, BF16),
    (F32, E4M3)], ids=["bf16-bf16", "bf16-e4m3", "bf16-f32", "f32-f32",
                       "f32-bf16", "f32-e4m3"])
def test_paged_chunk_path(q_dtype, kv_dtype, head_dim, group):
    wgmma = (q_dtype == BF16 and kv_dtype in (BF16, E4M3)
             and head_dim in (96, 128) and 128 % group == 0)
    assert paged_ops.kernel_path(q_dtype, kv_dtype, head_dim, group) == (
        "wgmma" if wgmma else "cuda_cores")


@pytest.mark.parametrize("cfg", [SELF, CAUSAL], ids=["self", "causal"])
@pytest.mark.parametrize("kv_dtype", [BF16, E4M3], ids=["bf16", "e4m3"])
def test_full_width_ardit_chunk_attention_takes_the_tensor_cores(cfg,
                                                                 kv_dtype):
    head_dim = cfg.d_model // cfg.n_heads
    group = cfg.n_heads // cfg.n_kv_heads
    assert paged_ops.kernel_path(BF16, kv_dtype, head_dim, group) == "wgmma"
    # SP2's half-head shards keep the group
    assert paged_ops.kernel_path(BF16, kv_dtype, head_dim, group) == \
        paged_ops.kernel_path(BF16, kv_dtype, head_dim,
                              (cfg.n_heads // 2) // (cfg.n_kv_heads // 2))
    reduced = cfg.reduced()
    assert paged_ops.kernel_path(
        F32, F32, reduced.d_model // reduced.n_heads,
        reduced.n_heads // reduced.n_kv_heads) == "cuda_cores"


@pytest.mark.parametrize("q_dtype", [F32, BF16, E4M3, torch.float16])
@pytest.mark.parametrize("kv_dtype", [F32, BF16, E4M3, torch.float16])
def test_decode_dtype_gate(q_dtype, kv_dtype):
    ok = q_dtype in (F32, BF16) and kv_dtype in (F32, BF16, E4M3)
    assert paged_ops.decode_dtypes_supported(q_dtype, kv_dtype) == ok


def test_cpu_chunk_and_decode_take_the_plain_versions():
    g = torch.Generator().manual_seed(1)
    q = torch.randn((1, 6, 4, 96), generator=g).bfloat16()
    pages = torch.randn((3, 8, 2, 96), generator=g).to(E4M3)
    table = torch.tensor([[2, 0]], dtype=torch.int32)
    before = (paged_ops.paged_chunk_attention.launches,
              paged_ops.paged_chunk_attention.launches_tc,
              paged_ops.paged_decode_attention.launches)
    m, l, acc = paged_ops.paged_chunk_attention(q, pages, pages, table, None,
                                                sink=5, chunk_tokens=8)
    assert acc.shape == (1, 2, 2, 6, 96) and acc.dtype == F32
    out = paged_ops.paged_decode_attention(
        q[:, 0], pages, pages, table, torch.tensor([11], dtype=torch.int32))
    assert out.shape == (1, 4, 96) and out.dtype == BF16
    assert bool(torch.isfinite(out.float()).all())
    assert (paged_ops.paged_chunk_attention.launches,
            paged_ops.paged_chunk_attention.launches_tc,
            paged_ops.paged_decode_attention.launches) == before
