"""Bit-plane storage format of the engine.

Signed ``bits``-bit weights are packed into int8 words along the
input-feature (K) axis, low bits first: for bits=4 two weights share a
byte, for bits=2 four, for bits=8 the word is the weight.  Device memory
then holds exactly ``bits/8`` bytes per weight, and a kernel unpacks the
codes in registers with shifts and masks.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_weights(q: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Pack signed ``bits``-bit integers (held in int8) along ``axis``.

    The packed words are contiguous, as the kernels take them, whatever
    the strides of ``q`` (a transposed view, for one)."""
    if bits == 8:
        return q.to(torch.int8).contiguous()
    per_byte = 8 // bits
    mask = (1 << bits) - 1
    if q.shape[axis] % per_byte != 0:
        raise ValueError(
            f"axis {axis} size {q.shape[axis]} not divisible by {per_byte}")
    q = torch.movedim(q, axis, 0).to(torch.int8).contiguous()
    u = q.view(torch.uint8) & mask  # two's-complement truncation to b bits
    u = u.reshape((q.shape[0] // per_byte, per_byte) + tuple(q.shape[1:]))
    word = torch.zeros_like(u[:, 0])
    for s in range(per_byte):
        word |= u[:, s] << (s * bits)
    return torch.movedim(word.view(torch.int8), 0, axis)


def unpack_weights(packed: torch.Tensor, bits: int,
                   axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_weights`; returns sign-extended int8 values."""
    if bits == 8:
        return packed.to(torch.int8)
    per_byte = 8 // bits
    mask = (1 << bits) - 1
    sign_bit = 1 << (bits - 1)
    p = torch.movedim(packed, axis, 0).contiguous().view(torch.uint8)
    digits = [(p >> (s * bits)) & mask for s in range(per_byte)]
    u = torch.stack(digits, dim=1).to(torch.int16)
    v = (u ^ sign_bit) - sign_bit  # sign extend
    v = v.reshape((p.shape[0] * per_byte,) + tuple(p.shape[1:]))
    return torch.movedim(v.to(torch.int8), 0, axis)


def to_bitplanes(q: np.ndarray, bits: int) -> np.ndarray:
    """Explicit bit-plane view, shape ``(bits,) + q.shape`` of 0/1:
    ``value = -2^{b-1}·plane[b-1] + Σ_{i<b-1} 2^i·plane[i]``."""
    q = np.asarray(q)
    u = q.astype(np.int64) & ((1 << bits) - 1)
    planes = np.stack([(u >> b) & 1 for b in range(bits)], axis=0)
    return planes.astype(np.uint8)


def from_bitplanes(planes: np.ndarray, bits: int) -> np.ndarray:
    """Reassemble signed integers from bit-planes."""
    weights = np.array([1 << b for b in range(bits - 1)]
                       + [-(1 << (bits - 1))])
    shape = (bits,) + (1,) * (planes.ndim - 1)
    return np.sum(planes.astype(np.int64) * weights.reshape(shape), axis=0)
