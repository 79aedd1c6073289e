"""``EnginePlan`` — the resolved dispatch object of the GEMV engine.

A plan is resolved once per run from an :class:`EngineConfig` and a device
(``resolve_plan``) and threaded through the model and the serving engine:
the GEMV backend, the digit radix, the KV precision and the attention read
path are pinned here.  Names are concrete, never ``"auto"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.engine.backends import (
    get_backend,
    resolve_attn_backend,
    resolve_backend_name,
)
from repro_torch.engine.packed import as_packed, validate_bits


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """``backend``: GEMV registry name; ``bits``: weight precision used when
    packing (0 = dense weights on a kv-only plan); ``radix``: bits retired
    per bit-serial pass; ``kv_bits``: 0 or 8 (int8 KV pages);
    ``attn_backend``: ``gather`` or ``cuda``.  Outputs take the activation
    dtype."""

    backend: str
    bits: int
    radix: int = 1
    kv_bits: int = 0
    attn_backend: str = "gather"

    def __post_init__(self):
        if self.kv_bits not in (0, 8):
            raise ValueError(f"kv_bits must be 0/8, got {self.kv_bits}")
        if self.bits or not self.kv_bits:
            validate_bits(self.bits)  # bits=0 only on a kv-only plan
        if self.radix not in (1, 2, 4, 8):
            raise ValueError(f"radix must be 1/2/4/8, got {self.radix}")
        if self.bits % self.radix != 0:
            raise ValueError(
                f"radix {self.radix} must divide bits {self.bits}")
        get_backend(self.backend)  # a typo fails here, not mid-step
        if self.attn_backend not in ("gather", "cuda"):
            raise KeyError(f"unknown attention backend {self.attn_backend!r}")

    def apply(self, lin, x: torch.Tensor) -> torch.Tensor:
        """``y = x @ W [+ bias]`` for ``x`` of shape ``(..., in_features)``.

        Leading dimensions are flattened to ``(M, K)`` before dispatch, so
        the GEMV kernel runs for the serve path's ``(B, 1, D)`` and
        ``(B, C, D)`` activations too.
        """
        lin = as_packed(lin, bits_hint=self.bits)
        lead = tuple(x.shape[:-1])
        y = get_backend(self.backend)(self, lin, x.reshape(-1, x.shape[-1]),
                                      x.dtype)
        y = y.reshape(lead + (y.shape[-1],))
        if lin.bias is not None:
            y = y + lin.bias.to(y.dtype)
        return y


def resolve_plan(cfg, *, device) -> Optional[EnginePlan]:
    """``EngineConfig`` (or None) -> ``EnginePlan`` (or None).

    None, or a config with ``weight_bits == 0`` and ``kv_bits == 0``,
    resolves to None: the plain dense path.  ``auto`` names resolve by
    ``device``.  A resolved plan is returned unchanged.
    """
    if cfg is None or isinstance(cfg, EnginePlan):
        return cfg
    if not cfg.enabled and not cfg.kv_bits:
        return None
    return EnginePlan(
        backend=resolve_backend_name(cfg.backend, device),
        bits=cfg.weight_bits,
        radix=cfg.radix,
        kv_bits=cfg.kv_bits,
        attn_backend=resolve_attn_backend(cfg.attn_backend, device),
    )


def plan_for_bits(bits: int, *, device) -> EnginePlan:
    """A standalone plan for a weight packed without a config."""
    return EnginePlan(backend=resolve_backend_name("auto", device),
                      bits=bits,
                      attn_backend=resolve_attn_backend("auto", device))
