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

from repro_torch.core.bitplane import pack_weights, unpack_weights
from repro_torch.core.quantize import quantize_symmetric

VALID_BITS = (2, 4, 8)


@dataclasses.dataclass(frozen=True)
class PackedLinear:
    """Weight-stationary bit-packed linear: ``y = x @ W [+ bias]``.

    ``packed``: int8 ``(..., in_features * bits // 8, out_features)``.
    ``scale``: float32 ``(..., 1, out_features)``.
    ``bias``: optional ``(out_features,)``.
    A leading axis, if any, stacks experts (``(E, Kp, N)`` with ``(E, 1,
    N)`` scales, the MoE layer's ``w_gate`` / ``w_up`` / ``w_down``).
    ``partition``: the preferred mesh partitioning, ``"col"`` / ``"row"``
    / None (auto), stamped by ``quantize_params`` from the weight's name
    as the JAX package stamps it.  ``shard``: how this object was cut
    from a whole weight for one rank (``dist.sharding.local_shard``):
    ``"col"`` (an N/m slice of codes, scales and bias), ``"row"`` (K/m
    packed rows, whole scales and bias), ``"expert"`` (stacked experts:
    a contiguous slice of the expert axis) or None (the whole weight);
    the feature counts are then the local ones.
    """

    packed: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor] = None
    bits: int = 8
    in_features: int = 0
    out_features: int = 0
    partition: Optional[str] = None
    shard: Optional[str] = None

    @property
    def per_byte(self) -> int:
        return 8 // self.bits

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """The float weight matrix (K axis unpacked)."""
        q = unpack_weights(self.packed, self.bits, axis=-2)
        return (q.to(torch.float32) * self.scale).to(dtype)

    def nbytes(self) -> int:
        """Device bytes of the codes, scales and bias, every expert."""
        return sum(t.numel() * t.element_size()
                   for t in (self.packed, self.scale, self.bias)
                   if t is not None)


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
                bias: Optional[torch.Tensor] = None,
                partition: Optional[str] = None) -> PackedLinear:
    """Quantize and bit-pack a float ``(K, N)`` weight, or a stack of
    experts ``(E, K, N)``, along K into engine form: one scale per output
    channel (per expert), as the JAX package's ``pack_linear`` does.
    ``partition``: ``"col"`` / ``"row"`` preference of the sharded
    backend (see :class:`PackedLinear`)."""
    bits = validate_bits(bits)
    if partition not in (None, "col", "row"):
        raise ValueError(
            f"partition must be 'col', 'row' or None, got {partition!r}")
    if w.ndim not in (2, 3):
        raise ValueError("weight must be (K, N) or stacked (E, K, N), got "
                         f"{tuple(w.shape)}")
    k, n = w.shape[-2:]
    if (k * bits) % 8 != 0:
        raise ValueError(
            f"in_features {k} * bits {bits} must pack into whole int8 words")
    q, scale = quantize_symmetric(w, bits, axis=-2)
    return PackedLinear(pack_weights(q, bits, axis=-2), scale, bias, bits, k,
                        n, partition)


def partition_kind(lin: PackedLinear, msize: int) -> str:
    """How one packed weight shards over a model axis of size ``msize``
    (the JAX package's rule).

    ``lin.partition`` states a preference and wins whenever its axis
    divides.  Otherwise ``"col"`` is preferred over ``"row"`` (no
    collective).  ``"row"`` requires both the packed int8 rows *and* the
    unpacked feature count to divide, so every shard unpacks whole
    features.  ``"replicate"``: stacked-expert weights, trivial meshes, or
    nothing divisible; never an error.
    """
    if lin.packed.ndim != 2 or msize <= 1:
        return "replicate"
    col_ok = lin.out_features > 0 and lin.out_features % msize == 0
    kp = lin.packed.shape[-2]
    row_ok = (kp % msize == 0 and lin.in_features > 0
              and lin.in_features % msize == 0)
    if lin.partition == "row" and row_ok:
        return "row"
    if lin.partition == "col" and col_ok:
        return "col"
    if col_ok:
        return "col"
    if row_ok:
        return "row"
    return "replicate"


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
