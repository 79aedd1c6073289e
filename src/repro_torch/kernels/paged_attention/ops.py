"""Public wrappers of the paged-attention kernels (decode and chunked
prefill).

They take the model layouts — decode ``q`` as ``(B, 1, Hq, Dh)``, prefill
``q`` as ``(B, C, Hq, Dh)``, pools as ``(P, page, Hkv, Dh)`` — and return
the same layout in ``q``'s dtype.  Dispatch is by the query's device: the
CUDA kernels for CUDA tensors (the grouped ``(…, Hkv, G, Dh)`` view is the
same memory, so nothing is copied or padded), the plain versions
(``ref.py``) for CPU tensors, an empty output for ``meta`` tensors inside
the op counter, and an error for anything else.  Each call opens
``op_cost.priced`` first (``bitplane_gemv/ops.py`` says why), at every
slot of the block table: the launchers read no length back from the
device, so on the card the count is an upper bound for a partly filled
table.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention.kernel import (
    paged_decode_attention_cuda,
    paged_prefill_attention_cuda,
    prefill_route,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_prefill_ref,
)
from repro_torch.roofline import kernel_costs, op_cost


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def paged_attention(
    q: torch.Tensor,              # (B, 1, Hq, Dh)
    k_pages: torch.Tensor,        # (P, page, Hkv, Dh)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (B, n_blocks)
    cur_pos: torch.Tensor,        # (B,)
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged decode attention; ``(B, 1, Hq, Dh)`` in ``q.dtype``."""
    with op_cost.priced("paged_decode_attention", lambda: (
            None, *kernel_costs.paged_decode_call(q, k_pages, block_tables,
                                                  k_scale))):
        if q.device.type == "cpu":
            return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       cur_pos, window, k_scale, v_scale)
        if op_cost.dry(q):
            return op_cost.meta_output(q.shape, q.dtype)
        return _decode_cuda(q, k_pages, v_pages, block_tables, cur_pos,
                            window, k_scale, v_scale)


def _decode_cuda(q, k_pages, v_pages, block_tables, cur_pos, window,
                 k_scale, v_scale):
    b, _, hq, d = q.shape
    hkv = k_pages.shape[2]
    out = paged_decode_attention_cuda(
        q.reshape(b, hkv, hq // hkv, d).contiguous(), k_pages, v_pages,
        _i32(block_tables), _i32(cur_pos), window, k_scale, v_scale)
    return out.reshape(b, 1, hq, d).to(q.dtype)


def paged_prefill_attention(
    q: torch.Tensor,              # (B, C, Hq, Dh)
    k_pages: torch.Tensor,        # (P, page, Hkv, Dh)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (B, n_blocks)
    pos0: torch.Tensor,           # (B,)
    seq_lens: torch.Tensor,       # (B,)
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged chunked-prefill attention; ``(B, C, Hq, Dh)`` in ``q.dtype``.
    The chunk's K/V must already be scattered into the pool."""
    with op_cost.priced("paged_prefill_attention", lambda: (
            op_cost.route_or_none(prefill_route, q.dtype, k_pages.dtype,
                                  q.shape[-1], q.shape[2] // k_pages.shape[2]),
            *kernel_costs.paged_prefill_call(q, k_pages, block_tables,
                                             k_scale))):
        if q.device.type == "cpu":
            return paged_prefill_ref(q, k_pages, v_pages, block_tables,
                                     pos0, seq_lens, window, k_scale,
                                     v_scale)
        if op_cost.dry(q):
            return op_cost.meta_output(q.shape, q.dtype)
        return _prefill_cuda(q, k_pages, v_pages, block_tables, pos0,
                             seq_lens, window, k_scale, v_scale)


def _prefill_cuda(q, k_pages, v_pages, block_tables, pos0, seq_lens, window,
                  k_scale, v_scale):
    b, c, hq, d = q.shape
    hkv = k_pages.shape[2]
    out = paged_prefill_attention_cuda(
        q.reshape(b, c, hkv, hq // hkv, d).contiguous(), k_pages, v_pages,
        _i32(block_tables), _i32(pos0), _i32(seq_lens), window, k_scale,
        v_scale)
    return out.reshape(b, c, hq, d).to(q.dtype)
