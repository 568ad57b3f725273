from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeConfig, SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K,
    LONG_500K, get_config, list_archs, register,
)
