"""The trace reduction's pure parts: kernel categories and gap labels."""
from streambench.lib.trace import _labeller, category


def test_categories():
    assert category("paged_chunk_attention_wgmma96_kernel") == \
        "paged_chunk_attention (kernel 1)"
    assert category("sm90_xmma_gemm_f32f32_tf32") == \
        "matmul fp32 (attention einsums)"
    assert category("nvjet_hsh_128x256") == "matmul (linear layers)"
    assert category("reduce_kernel<512>") == "exp / reductions"
    assert category("elementwise_kernel") == "other elementwise / copies"


def test_gap_labels():
    label = _labeller([(2.0, 3.0, "executor.run_step"),
                       (0.0, 1.0, "session.tick")])
    assert label(0.5) == "session.tick"
    assert label(2.5) == "executor.run_step"
    assert label(1.5) == "session loop outside tick and step"
