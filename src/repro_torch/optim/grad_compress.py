"""Int8 error-feedback gradient compression, the JAX package's
(``repro.optim.grad_compress``).

Compressing gradients to int8 before a cross-replica all-reduce cuts its
bytes 4x from float32; the quantization error is carried in an
error-feedback buffer so the *accumulated* update stays unbiased
(Karimireddy et al., 2019).  As in the JAX package's train step, the
compression applies to the gradients after they are reduced: these
functions are the per-leaf absmax scale, the round trip and the buffer.
On a mesh a leaf split over the model group takes the whole leaf's
absmax, a max over the group (``shards``), so every rank quantizes its
block with the scale one device would use.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_map

Tree = Any


def ef_state_init(grads: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_decompress(g: torch.Tensor, bits: int = 8,
                        group=None) -> torch.Tensor:
    """Quantize/dequantize round trip (what the wire would carry).
    ``group``: the ranks over which ``g``'s leaf is split (its absmax is
    then the max over them)."""
    qmax = 2 ** (bits - 1) - 1
    absmax = torch.amax(torch.abs(g))
    if group is not None:
        from repro_torch.dist.collectives import all_reduce

        absmax = all_reduce(absmax, group, op="max")
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(g / scale), -qmax, qmax).to(torch.int8)
    return q.to(torch.float32) * scale


@torch.no_grad()
def error_feedback_compress(grads: Tree, ef: Tree, bits: int = 8,
                            shards=None) -> Tuple[Tree, Tree]:
    """Returns (compressed_grads, new_ef): compressed + ef' == grads + ef.
    ``shards``: a rank's ``optim.LeafShards`` on a mesh."""
    targets = tree_map(lambda g, e: g.to(torch.float32) + e, grads, ef)
    if shards is None:
        sent = tree_map(lambda t: compress_decompress(t, bits), targets)
    else:
        sent = tree_map(lambda t, cut: compress_decompress(
            t, bits, shards.group if cut else None), targets, shards.cuts)
    new_ef = tree_map(torch.sub, targets, sent)
    return sent, new_ef
