"""Symmetric per-output-channel integer quantization.

The engine stores stationary weights as b-bit signed integers (two's
complement) with one float32 scale per output channel.
"""

from __future__ import annotations

import torch


def quantize_symmetric(w: torch.Tensor, bits: int, axis: int = 0):
    """Quantize ``w`` to signed ``bits``-bit integers, symmetric, per channel.

    ``axis`` is the reduction (input-feature) axis; scales are taken over it
    so each output channel owns one scale.  Returns ``(q, scale)``: ``q``
    int8 in ``[-(2^{b-1}-1), 2^{b-1}-1]`` and ``scale`` float32 with
    ``axis`` kept as size 1.  An all-zero channel gets scale 1.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2/4/8, got {bits}")
    qmax = 2 ** (bits - 1) - 1
    wf = w.to(torch.float32)
    absmax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)
