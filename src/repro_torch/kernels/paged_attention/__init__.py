from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    paged_chunk_attention, paged_decode_attention)
