"""Token sampling: greedy / temperature / top-k."""

from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """``(B, V)`` logits -> ``(B,)`` int64 token ids.

    Greedy (``temperature <= 0``) is an exact argmax, ties to the lowest
    id.  Otherwise tokens are drawn from ``softmax(logits / temperature)``
    (restricted to the top ``top_k`` when ``top_k > 0``) with
    ``generator``; the draws differ from JAX's for the same seed.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
