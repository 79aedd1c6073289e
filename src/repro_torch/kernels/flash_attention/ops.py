"""Public wrapper of the flash-attention kernel.

Takes the model's ``(B, S, H, D)`` layout, as the JAX package's
``kernels/flash_attention/ops.py`` does, and dispatches by the query's
device: the CUDA kernel for CUDA tensors (it reads that layout directly
and masks the ragged end of S itself, so nothing is transposed and S is
not padded; a head dim up to 256 outside 32 / 64 / 128 / 256 is
zero-padded to the next of them, one above 256 runs as it is on the
``wide`` route, the design that streams D), the plain version (``ref.py``,
``(B, H, S, D)``) for CPU tensors, an empty output for ``meta`` tensors
inside the op counter (``op_cost.dry``), and an error for anything else.
There is no fallback from the kernel to the plain version.  Each call
opens ``op_cost.priced`` first (``bitplane_gemv/ops.py`` says why).  The
kernel picks its own tiles: the JAX wrapper's ``block_q`` / ``block_kv``
have no counterpart.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_cuda,
    route,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.roofline import kernel_costs, op_cost


def flash_attention(
    q: torch.Tensor,         # (B, S, Hq, D) — model layout
    k: torch.Tensor,         # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Causal (+ window) GQA attention; ``(B, S, Hq, D)`` in q's dtype."""
    with op_cost.priced("flash_attention", lambda: (
            op_cost.route_or_none(route, q.dtype, q.shape[-1]),
            *kernel_costs.flash_attention_call(q, k, window))):
        if q.device.type == "cpu":
            out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), window=window)
            # the kernel's layout, so that the caller's ops are the same
            return out.transpose(1, 2).contiguous()
        if op_cost.dry(q):
            return op_cost.meta_output(q.shape, q.dtype)
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), window=window)
