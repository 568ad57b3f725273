from repro_torch.kernels.fp8_matmul.ops import (  # noqa: F401
    fp8_matmul, fp8_scaled_matmul, quantize_fp8)
