"""Attention paths of the serving model: dense masked attention, decode
over a KV view (full precision or int8), and decode / chunked-prefill
reads through a paged-KV block table.

All paths share GQA semantics: Hq query heads grouped over Hkv KV heads.
Contractions that the JAX package runs with
``preferred_element_type=float32`` run here on float32 copies of the
(storage-dtype-rounded where JAX rounds) operands.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _neg_inf(device) -> torch.Tensor:
    return torch.tensor(NEG_INF, dtype=torch.float32, device=device)


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
          window: int) -> torch.Tensor:
    """Causal (+ sliding window when ``window > 0``) mask, ``(…, Sq, Skv)``."""
    causal = kv_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        causal = causal & (kv_pos[..., None, :] > q_pos[..., :, None] - window)
    return causal


def attend_dense(
    q: torch.Tensor,             # (B, Sq, Hq, D)
    k: torch.Tensor,             # (B, Skv, Hkv, D)
    v: torch.Tensor,
    q_pos: torch.Tensor,         # (B, Sq)
    kv_pos: torch.Tensor,        # (B, Skv)
    window: int = 0,
    kv_valid: Optional[torch.Tensor] = None,   # (B, Skv) bool
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, hq // n_kv, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    mask = _mask(q_pos, kv_pos, window)[:, None, None]     # (B,1,1,Sq,Skv)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, None, :]
    scores = torch.where(mask, scores, _neg_inf(q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attend_dense_quant(
    q: torch.Tensor,             # (B, Sq, Hq, D)
    k: torch.Tensor,             # (B, Skv, Hkv, D) int8
    v: torch.Tensor,
    k_scale: torch.Tensor,       # (B, Skv, Hkv)
    v_scale: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    window: int = 0,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense attention over an int8 KV view: the scales fold into the
    scores and the probabilities (``s_t = (q·k_t)·s_k[t]``,
    ``out = Σ_t (p_t·s_v[t])·v_t``); q and p·s_v go through bf16."""
    b, sq, hq, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, hq // n_kv, d).to(torch.bfloat16).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    scores = scores * k_scale.float().transpose(1, 2)[:, :, None, None, :]
    mask = _mask(q_pos, kv_pos, window)[:, None, None]
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, None, :]
    scores = torch.where(mask, scores, _neg_inf(q.device))
    probs = torch.softmax(scores, dim=-1)
    pv = probs * v_scale.float().transpose(1, 2)[:, :, None, None, :]
    out = torch.einsum("bhgqk,bkhd->bqhgd", pv.to(torch.bfloat16).float(),
                       v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _decode_mask(cur_pos: torch.Tensor, t: int, window: int) -> torch.Tensor:
    kv_pos = torch.arange(t, device=cur_pos.device)
    return _mask(cur_pos.long()[:, None], kv_pos, window)[:, 0]   # (B, T)


def attend_decode(
    q: torch.Tensor,             # (B, 1, Hq, D)
    k_cache: torch.Tensor,       # (B, T, Hkv, D)
    v_cache: torch.Tensor,
    cur_pos: torch.Tensor,       # (B,) position of the newest token
    window: int = 0,
) -> torch.Tensor:
    """Single-token decode; q is rounded to the cache dtype before QK^T and
    p to the cache dtype before PV, as in the JAX package."""
    b, t, n_kv, d = k_cache.shape
    hq = q.shape[2]
    qg = q.reshape(b, n_kv, hq // n_kv, d).to(k_cache.dtype).float()
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * d ** -0.5
    valid = _decode_mask(cur_pos, t, window)
    sc = torch.where(valid[:, None, None, :], sc, _neg_inf(q.device))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def attend_decode_quant(
    q: torch.Tensor,             # (B, 1, Hq, D)
    k_cache: torch.Tensor,       # (B, T, Hkv, D) int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,       # (B, T, Hkv)
    v_scale: torch.Tensor,
    cur_pos: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Decode over an int8 cache: ``s_t = (q·k_t)·s_k[t]``,
    ``out = Σ_t (p_t·s_v[t])·v_t``; q and p·s_v go through bf16."""
    b, t, n_kv, d = k_cache.shape
    hq = q.shape[2]
    qg = q.reshape(b, n_kv, hq // n_kv, d).to(torch.bfloat16).float()
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * d ** -0.5
    sc = sc * k_scale.float().transpose(1, 2)[:, :, None, :]
    valid = _decode_mask(cur_pos, t, window)
    sc = torch.where(valid[:, None, None, :], sc, _neg_inf(q.device))
    p = torch.softmax(sc, dim=-1)
    pv = p * v_scale.float().transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhgk,bkhd->bhgd", pv.to(torch.bfloat16).float(),
                       v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def gather_kv_pages(pages: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Each lane's logical KV view from the pool: ``(P, page, ...)`` ->
    ``(B, n_blocks * page, ...)``; position ``t`` of lane ``b`` lives at
    ``pages[block_tables[b, t // page], t % page]``."""
    g = pages[block_tables.long()]                 # (B, nblk, page, ...)
    b, nblk, page = g.shape[:3]
    return g.reshape((b, nblk * page) + tuple(g.shape[3:]))


def attend_paged_decode(
    q: torch.Tensor,             # (B, 1, Hq, D)
    k_pages: torch.Tensor,       # (P, page, Hkv, D) — one layer's pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, n_blocks) int32
    cur_pos: torch.Tensor,       # (B,)
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,   # (P, page, Hkv) int8 pools
    v_scale: Optional[torch.Tensor] = None,
    attn_backend: str = "gather",
) -> torch.Tensor:
    """Single-token decode reading K/V through the block table.

    ``gather`` materialises each lane's logical view and attends (the
    reference); ``cuda`` runs the in-place paged kernel
    (``repro_torch.kernels.paged_attention``).
    """
    if attn_backend == "cuda":
        from repro_torch.kernels.paged_attention.ops import paged_attention

        return paged_attention(q, k_pages, v_pages, block_tables, cur_pos,
                               window, k_scale, v_scale)
    if attn_backend != "gather":
        raise ValueError(f"unknown attention backend {attn_backend!r}")
    kg = gather_kv_pages(k_pages, block_tables)
    vg = gather_kv_pages(v_pages, block_tables)
    if k_scale is not None:
        ksg = gather_kv_pages(k_scale, block_tables)
        vsg = gather_kv_pages(v_scale, block_tables)
        return attend_decode_quant(q, kg, vg, ksg, vsg, cur_pos, window)
    return attend_decode(q, kg, vg, cur_pos, window)


def attend_paged_prefill(
    q: torch.Tensor,             # (B, C, Hq, D) — one prefill chunk
    k_pages: torch.Tensor,       # (P, page, Hkv, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, n_blocks) int32
    positions: torch.Tensor,     # (B, C) logical positions of the chunk
    pos0: torch.Tensor,          # (B,) tokens already resident per lane
    seq_lens: torch.Tensor,      # (B,) total valid after this chunk
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    attn_backend: str = "gather",
) -> torch.Tensor:
    """One prefill chunk's attention through the block table: lane ``b``'s
    queries sit at ``[pos0[b], pos0[b] + C)`` and attend its resident
    prefix plus this chunk, causally, clipped to
    ``limit = min(seq_lens, pos0 + C)``.  The chunk's K/V must already be
    in the pool."""
    if attn_backend == "cuda":
        from repro_torch.kernels.paged_attention.ops import (
            paged_prefill_attention,
        )

        return paged_prefill_attention(q, k_pages, v_pages, block_tables,
                                       pos0, seq_lens, window, k_scale,
                                       v_scale)
    if attn_backend != "gather":
        raise ValueError(f"unknown attention backend {attn_backend!r}")
    b, c = q.shape[:2]
    t_total = block_tables.shape[1] * k_pages.shape[1]
    kv_pos = torch.arange(t_total, device=q.device)[None, :].expand(b, -1)
    limit = torch.minimum(seq_lens.long(), pos0.long() + c)
    kv_valid = kv_pos < limit[:, None]
    kg = gather_kv_pages(k_pages, block_tables)
    vg = gather_kv_pages(v_pages, block_tables)
    if k_scale is not None:
        ksg = gather_kv_pages(k_scale, block_tables)
        vsg = gather_kv_pages(v_scale, block_tables)
        return attend_dense_quant(q, kg, vg, ksg, vsg, positions, kv_pos,
                                  window, kv_valid=kv_valid)
    return attend_dense(q, kg, vg, positions, kv_pos, window,
                        kv_valid=kv_valid)
