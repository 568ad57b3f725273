"""Which hand-written CUDA kernel each wrapper picks, on the CPU.

``flash_attention.ops.kernel_path`` sends bf16 at head dims 64, 96 and
128 (every full-width model) to the tensor-core kernel and fp32 (the
reduced configs, held to 1e-4 against the CPU) and bf16 at D 16 to the
CUDA-core kernel; any other head dim is refused.
``fp8_matmul.ops.kernel_path`` sends shapes whose K and N are nonzero
multiples of 16 (TMA's 16-byte row strides; both FFN shapes of
the chip check) to the tensor-core kernel, the rest (the reference
tests' K 136 and 40, N 300) to the CUDA-core kernel.
``paged_attention.ops.kernel_path`` sends bf16 chunk queries over bf16
or e4m3 pages at D 96 and 128 with a group dividing 128 (every
full-width AR-DiT config) to the tensor-core kernel, and fp32 queries or
pages (the reduced configs), D 16 and bf16 queries over fp32 pages to
the CUDA-core kernel; ``decode_dtypes_supported`` is the decode kernel's
dtype gate: q fp32 or bf16 over pages of fp32, bf16 or e4m3, any mix,
as the reference widens all three to fp32.
``paged_attention.ops.decode_kernel_path`` sends bf16 decode queries over
bf16 or e4m3 pages at D 64 and 128 with a group of at most 8 and pages of
8, 16 or a multiple of 32 (minitron-8b's decode) to the split tensor-core
kernel, everything else to the CUDA-core kernel;
``ssd_scan.ops.kernel_path`` sends bf16 x/B/C at (P, N) = (64, 128)
(mamba2-780m) and (64, 16) (jamba-v0.1-52b) whose views TMA can read to
the tensor-core kernels, and fp32, the reduced (16, 16) and unaligned
views to the CUDA-core passes; any other (P, N) is refused.
All decide from the inputs alone.
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
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 16, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"),
    (torch.float32, 96, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"),
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


# ---------------------------------------------------------------------------
# the decode kernel's and the SSD kernel's tensor-core paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", [8, 64, 24])
@pytest.mark.parametrize("group", [4, 8, 12])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (BF16, BF16), (BF16, E4M3), (BF16, F32), (F32, F32), (F32, BF16),
    (F32, E4M3)], ids=["bf16-bf16", "bf16-e4m3", "bf16-f32", "f32-f32",
                       "f32-bf16", "f32-e4m3"])
def test_decode_path(q_dtype, kv_dtype, head_dim, group, page):
    mma = (q_dtype == BF16 and kv_dtype in (BF16, E4M3)
           and head_dim in (64, 128) and group <= 8
           and (page in (8, 16) or page % 32 == 0))
    assert paged_ops.decode_kernel_path(q_dtype, kv_dtype, head_dim, group,
                                        page) == (
        "mma" if mma else "cuda_cores")


@pytest.mark.parametrize("kv_dtype", [BF16, E4M3], ids=["bf16", "e4m3"])
def test_minitron_decode_takes_the_tensor_cores(kv_dtype):
    """minitron-8b's attention at decode_32k (Hq 32, Hkv 8, D 128, pages
    of 16): bf16 q over bf16 or e4m3 pages takes the split tensor-core
    kernel; fp32 q (the reference tests' shapes) the CUDA-core one."""
    from repro_torch.configs.minitron_8b import CONFIG as MINITRON
    g = MINITRON.n_heads // MINITRON.n_kv_heads
    assert (g, MINITRON.head_dim) == (4, 128)
    assert paged_ops.decode_kernel_path(BF16, kv_dtype, MINITRON.head_dim,
                                        g, 16) == "mma"
    assert paged_ops.decode_kernel_path(F32, kv_dtype, MINITRON.head_dim,
                                        g, 16) == "cuda_cores"


@pytest.mark.parametrize("aligned", [True, False], ids=["tma", "unaligned"])
@pytest.mark.parametrize("P,N", [(64, 128), (64, 16), (16, 16), (64, 64),
                                 (32, 128)])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_ssd_path(dtype, P, N, aligned):
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    tc = dtype == BF16 and (P, N) in ((64, 128), (64, 16)) and aligned
    assert ssd_ops.kernel_path(dtype, P, N, aligned) == (
        "wgmma" if tc else "cuda_cores")


def test_mamba_full_width_prefill_takes_the_tensor_cores():
    """mamba2-780m at full width (bf16, heads of 64, state 128) and the
    model's x/B/C views of the conv output (token stride H*P + 2N) take
    the tensor-core SSD kernel; the reduced config and fp32 weights take
    the CUDA-core kernel."""
    from repro_torch.configs.mamba2_780m import CONFIG as MAMBA
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    hd, n = MAMBA.ssm_head_dim, MAMBA.ssm_state
    heads = MAMBA.ssm_expand * MAMBA.d_model // hd
    xbc = torch.zeros((2, 64, heads * hd + 2 * n), dtype=BF16)
    xi, Bp, Cp = torch.split(xbc, [heads * hd, n, n], dim=-1)
    views = (xi.reshape(2, 64, heads, hd), Bp.reshape(2, 64, 1, n),
             Cp.reshape(2, 64, 1, n))
    assert ssd_ops.kernel_path(BF16, hd, n, ssd_ops._tma_aligned(*views)) \
        == "wgmma"
    assert ssd_ops.kernel_path(F32, hd, n) == "cuda_cores"
    red = MAMBA.reduced()
    assert ssd_ops.kernel_path(BF16, red.ssm_head_dim,
                               red.ssm_state) == "cuda_cores"


def test_jamba_full_width_prefill_takes_the_tensor_cores():
    """jamba-v0.1-52b at full width (bf16, heads of 64, state 16): the
    model's x/B/C views of its conv output (8,192 + 2 x 16 channels, a
    token stride of 16,448 bytes, C from byte 16,416) are TMA-aligned
    and take the tensor-core SSD kernel; fp32 weights and the reduced
    config take the CUDA-core passes."""
    from repro_torch.configs.jamba_v0_1_52b import CONFIG as JAMBA
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    hd, n = JAMBA.ssm_head_dim, JAMBA.ssm_state
    heads = JAMBA.ssm_expand * JAMBA.d_model // hd
    assert (hd, n, heads * hd) == (64, 16, 8192)
    xbc = torch.zeros((2, 64, heads * hd + 2 * n), dtype=BF16)
    xi, Bp, Cp = torch.split(xbc, [heads * hd, n, n], dim=-1)
    views = (xi.reshape(2, 64, heads, hd), Bp.reshape(2, 64, 1, n),
             Cp.reshape(2, 64, 1, n))
    assert views[0].stride(1) * 2 == 16448
    assert views[2].data_ptr() - xbc.data_ptr() == 16416
    assert ssd_ops._tma_aligned(*views)
    assert ssd_ops.kernel_path(BF16, hd, n, ssd_ops._tma_aligned(*views)) \
        == "wgmma"
    assert ssd_ops.kernel_path(F32, hd, n) == "cuda_cores"
    red = JAMBA.reduced()
    assert ssd_ops.kernel_path(BF16, red.ssm_head_dim,
                               red.ssm_state) == "cuda_cores"


def test_ssd_alignment_of_views():
    """TMA needs 16-byte bases and batch / token strides that are
    multiples of 8 bf16 elements: a view one element off is refused by
    the tensor-core path and named so by kernel_path."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    base = torch.zeros((2, 40, 4 * 64 + 256 + 8), dtype=BF16)
    ok = base[..., :4 * 64].reshape(2, 40, 4, 64)
    assert ssd_ops._tma_aligned(ok)
    odd = torch.zeros((2, 40, 4 * 64 + 257), dtype=BF16)
    off = odd[..., 1:4 * 64 + 1].reshape(2, 40, 4, 64)
    assert not ssd_ops._tma_aligned(off)


TOKEN_ARCHS = ["minitron-8b", "internlm2-20b", "qwen1.5-32b", "minicpm-2b",
               "granite-moe-1b-a400m", "qwen3-moe-235b-a22b",
               "internvl2-26b", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_token_families_prefill_on_the_tensor_cores(arch):
    """Every dense / MoE / VLM / hybrid config at full width (bf16,
    heads of 64 or 128) prefills on the tensor-core flash kernel; its
    reduced config (fp32, heads of 16) on the CUDA cores."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    assert cfg.param_dtype == "bfloat16" and cfg.head_dim in (64, 128)
    assert flash_ops.kernel_path(BF16, cfg.head_dim) == "wgmma"
    red = cfg.reduced()
    assert flash_ops.kernel_path(F32, red.head_dim) == "cuda_cores"


def test_jamba_mamba_sublayers_take_the_cuda_core_passes():
    """jamba-v0.1-52b's SSD at full width, (P, N) = (64, 16): the three
    CUDA-core passes in fp32 over the model's x/B/C views, and in bf16
    over views TMA cannot read (rows one element longer); bf16 over the
    model's own views takes the tensor cores."""
    from repro_torch.configs.jamba_v0_1_52b import CONFIG as JAMBA
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    hd, n = JAMBA.ssm_head_dim, JAMBA.ssm_state
    assert (hd, n) == (64, 16) and (hd, n) in ssd_ops._SHAPES
    heads = JAMBA.ssm_expand * JAMBA.d_model // hd
    xbc = torch.zeros((2, 64, heads * hd + 2 * n), dtype=BF16)
    xi, Bp, Cp = torch.split(xbc, [heads * hd, n, n], dim=-1)
    aligned = ssd_ops._tma_aligned(xi.reshape(2, 64, heads, hd),
                                   Bp.reshape(2, 64, 1, n),
                                   Cp.reshape(2, 64, 1, n))
    assert aligned
    assert ssd_ops.kernel_path(F32, hd, n, aligned) == "cuda_cores"
    assert ssd_ops.kernel_path(BF16, hd, n, aligned) == "wgmma"
    odd = torch.zeros((2, 64, heads * hd + 2 * n + 1), dtype=BF16)
    xo, Bo, Co, _ = torch.split(odd, [heads * hd, n, n, 1], dim=-1)
    assert not ssd_ops._tma_aligned(xo.reshape(2, 64, heads, hd),
                                    Bo.reshape(2, 64, 1, n),
                                    Co.reshape(2, 64, 1, n))
    assert ssd_ops.kernel_path(BF16, hd, n, False) == "cuda_cores"


@pytest.mark.parametrize("dtype,aligned,path", [
    (F32, True, "wgmma"), (BF16, False, "wgmma"), (BF16, True, "mma")],
    ids=["f32-wgmma", "unaligned-wgmma", "unknown"])
def test_ssd_refuses_a_path_it_has_no_kernel_for(dtype, aligned, path):
    """``path`` may pick the CUDA-core passes where the tensor cores
    would run, never the tensor cores where they cannot (fp32, a view
    TMA cannot read) or a path that does not exist: refused before any
    launch."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    H, P, N = 2, 64, 16
    wide = torch.zeros((1, 8, H * P + 2 * N + (0 if aligned else 1)),
                       dtype=dtype)
    xi, Bp, Cp = torch.split(wide, [H * P, N, N], dim=-1)[:3] \
        if aligned else torch.split(wide, [H * P, N, N, 1], dim=-1)[:3]
    x, Bm, Cm = xi.reshape(1, 8, H, P), Bp.reshape(1, 8, 1, N), \
        Cp.reshape(1, 8, 1, N)
    assert ssd_ops._tma_aligned(x, Bm, Cm) == aligned
    with pytest.raises(ValueError, match=f"no '{path}' kernel"):
        ssd_ops._launch(x, torch.zeros((1, 8, H)), torch.zeros((H,)), Bm,
                        Cm, 8, None, path)


@pytest.mark.parametrize("D", [32, 48, 80, 256])
def test_flash_refuses_other_head_dims(D):
    """A head dim the kernel does not instantiate is refused before any
    launch (no fallback to the plain version)."""
    q = torch.zeros((1, 8, 2, D), dtype=BF16)
    with pytest.raises(ValueError, match="head dims"):
        flash_ops._launch(q, q, q, 2, True, 0, 0, 0, 0.0, 8, 8)


@pytest.mark.parametrize("P,N", [(64, 64), (32, 16), (128, 16)])
def test_ssd_refuses_other_shapes(P, N):
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    x = torch.zeros((1, 8, 2, P), dtype=BF16)
    bc = torch.zeros((1, 8, 1, N), dtype=BF16)
    with pytest.raises(ValueError, match="not in"):
        ssd_ops._launch(x, torch.zeros((1, 8, 2)), torch.zeros((2,)), bc,
                        bc, 8, None)
