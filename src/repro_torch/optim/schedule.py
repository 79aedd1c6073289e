"""LR schedules."""

from __future__ import annotations

import math

import torch


def cosine_warmup(step, base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_frac * base_lr`` at ``total``; a float32 tensor on
    ``step``'s device (``step`` an int or a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    # (step+1)/warmup: the first optimizer step must not be a no-op
    warm = base_lr * torch.clamp((step + 1.0) / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
