"""Head-dim padding for the attention tiles that take a few widths only.

Flash attention's tile routes and the chunked prefill's tensor-core route
are compiled for head dims of ``TILE_HEAD_DIMS``.  Their launchers take any
D up to the widest: they zero-pad the head dim to the next width the tiles
take, pass the softmax scale of the true D, and slice the output back.
Zero columns add exact zeros to every score and give zero output columns,
so the function is the reference's at the true D, and the same kernel runs
(no other route, no fallback).  Above the widest, the route functions
name a route that takes D as it is: flash attention's ``wide``, which
streams D (``csrc/flash_attention.cu``), and the chunked prefill's
``cuda_core``, which holds rows of any Dh in shared memory
(``csrc/paged_attention.cu``): :func:`padded_head_dim` serves the tiles
only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TILE_HEAD_DIMS = (32, 64, 128, 256)
WIDEST_TILE = TILE_HEAD_DIMS[-1]


def padded_head_dim(d: int, what: str) -> int:
    """The narrowest width of ``TILE_HEAD_DIMS`` that holds ``d``; raises
    for ``d`` above the widest (``what`` names the caller), which no tile
    takes and the route functions send to the ``wide`` / ``cuda_core``
    routes."""
    for width in TILE_HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"{what}: head dim {d} > {TILE_HEAD_DIMS[-1]}, the "
                     "widest its tiles take")


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to ``width`` (a new contiguous
    tensor), or ``t`` itself when it already has that width."""
    d = t.shape[-1]
    return t if d == width else F.pad(t, (0, width - d))
