"""Plain PyTorch version of the int8 bit-parallel GEMV kernel.

One float32 product of the activations with the int8 codes, the
per-channel scale applied once after the whole K sum (as the TPU kernel
does).  The wrappers run it for CPU tensors, and the CUDA kernel is held
against it on the card.
"""

from __future__ import annotations

import torch


def int8_matvec_ref(q: torch.Tensor, scale: torch.Tensor, x: torch.Tensor,
                    *, out_dtype=torch.float32) -> torch.Tensor:
    """``((x @ q) * scale)`` for q ``(K, N)`` int8, scale ``(1, N)``
    float32 and x ``(M, K)``, accumulated in float32."""
    return ((x.to(torch.float32) @ q.to(torch.float32)) * scale).to(out_dtype)
