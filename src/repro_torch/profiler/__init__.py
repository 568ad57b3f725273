from repro_torch.profiler.profiles import (  # noqa: F401
    ChunkProfile, ModelProfile, get_profile,
)
