from repro_torch.config.base import (
    SHAPES,
    EngineConfig,
    MeshConfig,
    ModelConfig,
    RunConfig,
    ServeConfig,
    ShapeConfig,
    TrainConfig,
)
from repro_torch.config.registry import get_arch, get_reduced, register_arch

__all__ = [
    "EngineConfig",
    "MeshConfig",
    "ModelConfig",
    "RunConfig",
    "ServeConfig",
    "ShapeConfig",
    "TrainConfig",
    "SHAPES",
    "get_arch",
    "get_reduced",
    "register_arch",
]
