"""Public wrapper of the flash-attention kernel.

Takes the model's ``(B, S, H, D)`` layout, as the JAX package's
``kernels/flash_attention/ops.py`` does, and dispatches by the query's
device: the CUDA kernel for CUDA tensors (it reads that layout directly
and masks the ragged end of S itself, so nothing is transposed and S is
not padded; a head dim outside 32 / 64 / 128 is zero-padded to the next
of them), the plain version (``ref.py``, ``(B, H, S, D)``) for CPU tensors,
and an error for anything else.  There is no fallback from the kernel to
the plain version.  The kernel picks its own tiles: the JAX wrapper's
``block_q`` / ``block_kv`` have no counterpart.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(
    q: torch.Tensor,         # (B, S, Hq, D) — model layout
    k: torch.Tensor,         # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Causal (+ window) GQA attention; ``(B, S, Hq, D)`` in q's dtype."""
    if q.device.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), window=window)
        return out.transpose(1, 2)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), window=window)
