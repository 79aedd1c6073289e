"""``--arch`` registry of the port.

Each module in ``repro_torch/configs/`` defines ``CONFIG`` (published
dimensions) and ``reduced()`` (a tiny same-family config for CPU tests) and
calls :func:`register_arch`; lookups import the module lazily.  Only the
architectures the port serves are listed.
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
    "mamba2-130m": "mamba2_130m",
    "qwen2.5-3b": "qwen2_5_3b",
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
