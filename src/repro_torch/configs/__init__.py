from repro_torch.configs.base import (
    GNNConfig,
    LMConfig,
    MoEConfig,
    RecSysConfig,
    ShapeSpec,
    shapes_for,
)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shapes, get_smoke

__all__ = [
    "GNNConfig", "LMConfig", "MoEConfig", "RecSysConfig", "ShapeSpec",
    "shapes_for", "ARCH_IDS", "get_config", "get_shapes", "get_smoke",
]
