"""The frozen quality surface against its table."""
import pytest

from streambench.lib.quality import chunk_quality

TABLE = [  # key, model, VBench points (App. A's surface)
    ("S4_r0.0_W7_bf16", "self-forcing", 80.9),
    ("S4_r0.0_W7_bf16", "causal-forcing", 81.3),
    ("S4_r0.0_W7_fp8", "self-forcing", 80.55),
    ("S2_r0.0_W7_bf16", "self-forcing", 80.9 - 0.55 * 2 ** 1.6),
    ("S4_r0.0_W1_bf16", "causal-forcing", 81.3 - 1.1 * (6 / 7) ** 1.4),
    ("S3_r0.6_W3_fp8", "self-forcing",
     80.9 - 0.55 - 2.6 * 0.6 ** 2.5 * (3 / 7) ** 0.5
     - 1.1 * (4 / 7) ** 1.4 - 0.35 - 0.8 * 0.6 / 2),
    ("S4_r0.0_W7_bf16_cc", "self-forcing", 80.9 - 0.18),
]


@pytest.mark.parametrize("key,model,want", TABLE)
def test_surface(key, model, want):
    assert chunk_quality(key, model) == pytest.approx(want, abs=1e-12)
