from repro_torch.config.base import EngineConfig, ModelConfig, ServeConfig
from repro_torch.config.registry import get_arch, get_reduced, register_arch

__all__ = [
    "EngineConfig",
    "ModelConfig",
    "ServeConfig",
    "get_arch",
    "get_reduced",
    "register_arch",
]
