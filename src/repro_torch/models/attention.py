"""Attention paths of the model: dense masked attention, chunked flash
attention over a whole sequence, decode over a KV view (full precision or
int8), and decode / chunked-prefill reads through a paged-KV block table.

All paths share GQA semantics: Hq query heads grouped over Hkv KV heads.
Contractions that the JAX package runs with
``preferred_element_type=float32`` run here on float32 copies of the
(storage-dtype-rounded where JAX rounds) operands.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
FLASH_THRESHOLD = 4096  # full-sequence paths switch to flash at this length
FLASH_BLOCK_Q = 512
FLASH_BLOCK_KV = 1024


def _neg_inf(device) -> torch.Tensor:
    # a fill on the device, not a copy of host data: safe inside a CUDA
    # graph capture
    return torch.full((), NEG_INF, dtype=torch.float32, device=device)


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


def attend_flash(
    q: torch.Tensor,             # (B, S, Hq, D)
    k: torch.Tensor,             # (B, S, Hkv, D)
    v: torch.Tensor,
    positions: torch.Tensor,     # (B, S)
    window: int = 0,
    block_q: int = FLASH_BLOCK_Q,
    block_kv: int = FLASH_BLOCK_KV,
    *,
    attn_backend: str = "gather",
    sequential: bool = False,
) -> torch.Tensor:
    """Causal (+ window) attention over a whole sequence without S×S
    scores.

    ``cuda`` runs the flash kernel (``repro_torch.kernels.flash_attention``),
    which masks by index from 0, so it needs positions ``0..S-1`` in every
    row: the caller says so with ``sequential=True`` (``forward`` and
    ``prefill`` without batch-given positions), and anything else raises
    rather than attending with the wrong mask.  ``gather`` is the plain
    version: the JAX package's chunked online softmax over query and key
    blocks (``attention.py:154-220``), scores in float32 and ``p`` cast to
    v's dtype before ``p·v``.  Fully masked key blocks are still computed
    and contribute nothing, as there.
    """
    if attn_backend == "cuda":
        if not sequential:
            raise NotImplementedError(
                "attend_flash: the flash kernel masks by index from 0 and "
                "needs positions 0..S-1 in every row; batch-given positions "
                "are not supported on this route")
        from repro_torch.kernels.flash_attention.ops import flash_attention

        return flash_attention(q, k, v, window=window)
    if attn_backend != "gather":
        raise ValueError(f"unknown attention backend {attn_backend!r}")
    b, s, hq, d = q.shape
    n_kv = k.shape[2]
    g = hq // n_kv
    block_q = min(block_q, s)
    block_kv = min(block_kv, s)
    blk = max(block_q, block_kv)
    if s % blk:
        # pad to a block multiple; padded keys sit at position 2^30, above
        # every real query, and padded query rows are sliced off
        pad = blk - s % blk
        padded = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                  for t in (q, k, v)]
        pos = torch.nn.functional.pad(positions, (0, pad), value=2 ** 30)
        return attend_flash(*padded, pos, window, block_q, block_kv)[:, :s]
    scale = d ** -0.5
    out = torch.empty_like(q)
    for q0 in range(0, s, block_q):
        qg = q[:, q0:q0 + block_q].reshape(b, block_q, n_kv, g, d).float()
        q_pos = positions[:, q0:q0 + block_q]
        m = torch.full((b, n_kv, g, block_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n_kv, g, block_q, d), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, s, block_kv):
            k_blk = k[:, k0:k0 + block_kv]
            v_blk = v[:, k0:k0 + block_kv]
            sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk.float()) * scale
            msk = _mask(q_pos, positions[:, k0:k0 + block_kv],
                        window)[:, None, None]
            sc = torch.where(msk, sc, _neg_inf(q.device))
            new_m = torch.maximum(m, sc.amax(dim=-1))
            corr = torch.exp(m - new_m)
            p = torch.exp(sc - new_m[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd",
                              p.to(v_blk.dtype).float(), v_blk.float())
            acc = acc * corr[..., None] + pv
            m = new_m
        o = acc / torch.clamp(l, min=1e-30)[..., None]      # (B,Hkv,G,bq,D)
        out[:, q0:q0 + block_q] = o.permute(0, 3, 1, 2, 4).reshape(
            b, block_q, hq, d).to(q.dtype)
    return out


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
