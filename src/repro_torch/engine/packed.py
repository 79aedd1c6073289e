"""``PackedLinear`` — the weight format of the IMAGine GEMV engine.

``packed`` holds the b-bit two's-complement codes of ``W`` packed along the
contraction (K) axis into int8 words, so device memory holds ``bits/8``
bytes per weight; ``scale`` holds one float32 scale per output channel.
``bits`` is validated once, at pack time, and is authoritative: every
backend reads the precision from the weight, never from a config default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.bitplane import pack_weights
from repro_torch.core.quantize import quantize_symmetric

VALID_BITS = (2, 4, 8)


@dataclasses.dataclass(frozen=True)
class PackedLinear:
    """Weight-stationary bit-packed linear: ``y = x @ W [+ bias]``.

    ``packed``: int8 ``(in_features * bits // 8, out_features)``.
    ``scale``: float32 ``(1, out_features)``.
    ``bias``: optional ``(out_features,)``.
    """

    packed: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor] = None
    bits: int = 8
    in_features: int = 0
    out_features: int = 0


def validate_bits(bits: Any) -> int:
    if bits is None:
        raise ValueError(
            "engine weight precision is unset: PackedLinear.bits is "
            "authoritative and must be one of {2, 4, 8}")
    bits = int(bits)
    if bits not in VALID_BITS:
        raise ValueError(f"bits must be one of {VALID_BITS}, got {bits}")
    return bits


def pack_linear(w: torch.Tensor, bits: int = 8, *,
                bias: Optional[torch.Tensor] = None) -> PackedLinear:
    """Quantize and bit-pack a float ``(K, N)`` weight into engine form."""
    bits = validate_bits(bits)
    if w.ndim != 2:
        raise ValueError(f"weight must be 2-D (K, N), got {tuple(w.shape)}")
    k, n = w.shape
    if (k * bits) % 8 != 0:
        raise ValueError(
            f"in_features {k} * bits {bits} must pack into whole int8 words")
    q, scale = quantize_symmetric(w, bits, axis=0)
    return PackedLinear(pack_weights(q, bits, axis=0), scale, bias, bits, k, n)


def as_packed(p: Any, *, bits_hint: Optional[int] = None) -> PackedLinear:
    """A ``PackedLinear`` (identity), the legacy ``QuantizedLinear``
    (``repro_torch.core.gemv_engine``) or a ``{"packed", "scale"[, "bits",
    "bias"]}`` dict as ``PackedLinear``; a dict without ``bits`` needs an
    explicit ``bits_hint``."""
    if isinstance(p, PackedLinear):
        return p
    # QuantizedLinear and other NamedTuple-likes with the same fields
    if hasattr(p, "packed") and hasattr(p, "scale") and hasattr(p, "bits"):
        bits = validate_bits(p.bits)
        k = getattr(p, "in_features", p.packed.shape[-2] * (8 // bits))
        n = getattr(p, "out_features", p.packed.shape[-1])
        return PackedLinear(p.packed, p.scale, None, bits, k, n)
    if isinstance(p, dict) and "packed" in p:
        bits = validate_bits(p.get("bits", bits_hint))
        packed = p["packed"]
        return PackedLinear(packed, p["scale"], p.get("bias"), bits,
                            packed.shape[-2] * (8 // bits), packed.shape[-1])
    raise TypeError(
        f"cannot interpret {type(p).__name__} as an engine PackedLinear")


def is_packed(p: Any) -> bool:
    return isinstance(p, PackedLinear) or (isinstance(p, dict)
                                           and "packed" in p)
