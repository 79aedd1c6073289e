"""``--arch`` registry of the port.

Each module in ``repro_torch/configs/`` defines ``CONFIG`` (published
dimensions) and ``reduced()`` (a tiny same-family config for CPU tests) and
calls :func:`register_arch`; lookups import the module lazily.  Every
architecture of the JAX package is listed.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

from repro_torch.config.base import ModelConfig

_REGISTRY: Dict[str, "ArchEntry"] = {}


class ArchEntry:
    def __init__(self, arch_id: str, config: ModelConfig,
                 reduced: Callable[[], ModelConfig]):
        self.arch_id = arch_id
        self.config = config
        self.reduced = reduced


def register_arch(arch_id: str, config: ModelConfig,
                  reduced: Callable[[], ModelConfig]) -> None:
    if arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch id {arch_id!r}")
    _REGISTRY[arch_id] = ArchEntry(arch_id, config, reduced)


_ARCH_MODULES = {
    "gemma3-27b": "gemma3_27b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "mamba2-130m": "mamba2_130m",
    "mistral-large-123b": "mistral_large_123b",
    "musicgen-medium": "musicgen_medium",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "starcoder2-15b": "starcoder2_15b",
    "zamba2-7b": "zamba2_7b",
}


def _load(arch_id: str) -> ArchEntry:
    if arch_id not in _REGISTRY:
        mod = _ARCH_MODULES.get(arch_id)
        if mod is None:
            raise KeyError(
                f"arch {arch_id!r} is not ported; available: "
                f"{sorted(_ARCH_MODULES)}")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[arch_id]


def get_arch(arch_id: str) -> ModelConfig:
    return _load(arch_id).config


def get_reduced(arch_id: str) -> ModelConfig:
    return _load(arch_id).reduced()
