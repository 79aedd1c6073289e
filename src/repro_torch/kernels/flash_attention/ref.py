"""Plain PyTorch version of the flash-attention kernel: masked softmax
attention in ``(B, H, S, D)`` layout, scores, softmax and ``p·v`` in
float32, output in ``q``'s dtype — the arithmetic of the JAX package's
``kernels/flash_attention/ref.py``.  The wrapper runs it for CPU tensors,
and the CUDA kernel is held against it on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0) -> torch.Tensor:
    """Causal (+ sliding window when ``window > 0``) GQA attention; q
    ``(B, Hq, S, D)``, k/v ``(B, Hkv, S, D)``, query head ``h`` reads KV
    head ``h // (Hq // Hkv)``."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, s, d)
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * d ** -0.5
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    sc = torch.where(mask, sc, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)
