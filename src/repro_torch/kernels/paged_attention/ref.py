"""Plain PyTorch versions of the paged-attention kernels.

Gather-then-attend: each lane's logical KV view is materialised from the
page pool through its block table, then attended — the same arithmetic as
the JAX package's ``kernels/paged_attention/ref.py`` and its ``gather``
serving path, cast for cast.  The wrappers run these for CPU tensors, and
the CUDA kernels are held against them on the card.

Contractions that JAX runs with ``preferred_element_type=float32`` are run
here on float32 copies of the (bf16-rounded where JAX rounds) operands:
the products are the same and the sums are float32.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def gather_pages(pages: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """``(P, page, ...)`` pool -> ``(B, n_blocks * page, ...)`` logical view:
    position ``t`` of lane ``b`` is ``pages[block_tables[b, t // page],
    t % page]``."""
    g = pages[block_tables.long()]                 # (B, nblk, page, ...)
    b, nblk, page = g.shape[:3]
    return g.reshape((b, nblk * page) + tuple(g.shape[3:]))


def _window_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                 window: int) -> torch.Tensor:
    """Causal (+ sliding window when ``window > 0``) mask, ``(…, Sq, Skv)``."""
    causal = kv_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        near = kv_pos[..., None, :] > (q_pos[..., :, None] - window)
        causal = causal & near
    return causal


def paged_attention_ref(
    q: torch.Tensor,              # (B, 1, Hq, Dh)
    k_pages: torch.Tensor,        # (P, page, Hkv, Dh)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (B, n_blocks) int32
    cur_pos: torch.Tensor,        # (B,)
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,   # (P, page, Hkv) int8 pools
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention over the gathered view; ``(B, 1, Hq, Dh)``."""
    b, _, hq, d = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    kg = gather_pages(k_pages, block_tables)       # (B, T, Hkv, Dh)
    vg = gather_pages(v_pages, block_tables)
    t = kg.shape[1]
    quant = k_scale is not None
    acc_in = torch.bfloat16 if quant else kg.dtype
    qg = q.reshape(b, hkv, g, d).to(acc_in).float()
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, kg.to(acc_in).float()) * scale
    if quant:
        ksg = gather_pages(k_scale, block_tables).float()   # (B, T, Hkv)
        sc = sc * ksg.transpose(1, 2)[:, :, None, :]
    kv_pos = torch.arange(t, device=q.device)
    valid = _window_mask(cur_pos.long()[:, None], kv_pos, window)[:, 0]
    sc = torch.where(valid[:, None, None, :], sc, torch.tensor(
        NEG_INF, device=q.device))
    p = torch.softmax(sc, dim=-1)
    if quant:
        vsg = gather_pages(v_scale, block_tables).float()
        p = p * vsg.transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(acc_in).float(),
                       vg.to(acc_in).float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def paged_prefill_ref(
    q: torch.Tensor,              # (B, C, Hq, Dh) — one prefill chunk
    k_pages: torch.Tensor,        # (P, page, Hkv, Dh)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (B, n_blocks) int32
    pos0: torch.Tensor,           # (B,) tokens already resident
    seq_lens: torch.Tensor,       # (B,) total valid after this chunk
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked-prefill attention over the gathered view: causal over
    logical positions, keys clipped to ``min(seq_lens, pos0 + C)``;
    ``(B, C, Hq, Dh)``."""
    b, c, hq, d = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    kg = gather_pages(k_pages, block_tables)       # (B, T, Hkv, Dh)
    vg = gather_pages(v_pages, block_tables)
    t = kg.shape[1]
    quant = k_scale is not None
    acc_in = torch.bfloat16 if quant else torch.float32
    qg = q.reshape(b, c, hkv, g, d).to(acc_in).float()
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                      kg.to(acc_in).float()) * scale
    if quant:
        ksg = gather_pages(k_scale, block_tables).float()
        sc = sc * ksg.transpose(1, 2)[:, :, None, None, :]
    pos0 = pos0.long()
    q_pos = pos0[:, None] + torch.arange(c, device=q.device)[None, :]
    kv_pos = torch.arange(t, device=q.device)[None, :]
    limit = torch.minimum(seq_lens.long(), pos0 + c)
    mask = _window_mask(q_pos, kv_pos, window)               # (B, C, T)
    mask = mask & (kv_pos < limit[:, None])[:, None, :]
    sc = torch.where(mask[:, None, None], sc, torch.tensor(
        NEG_INF, device=q.device))
    p = torch.softmax(sc, dim=-1)
    if quant:
        vsg = gather_pages(v_scale, block_tables).float()
        p = p * vsg.transpose(1, 2)[:, :, None, None, :]
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(acc_in).float(),
                       vg.to(acc_in).float())
    return out.reshape(b, c, hq, d).to(q.dtype)
