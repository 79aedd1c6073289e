"""Decoder LM of the dense family, for paged serving.

Parameters are a plain dictionary::

    {"embed": (V, D), "final_norm": (D,),
     "layers": [{"ln1", "attn": {"wq", "wk", "wv", "wo"},
                 "ln2", "mlp": {"w_gate", "w_up", "w_down"}}, ...]}

with one entry per layer (the JAX package stacks layers on a leading axis
and scans; here the layer loop is a Python loop).  A linear is
``{"w": (K, N)[, "bias"]}`` or, after :func:`quantize_params`, an engine
:class:`~repro_torch.engine.PackedLinear`.

:func:`decode_step_paged` and :func:`prefill_chunk` write the new K/V into
the page pool **in place** (``index_put_``), where the JAX package returns
a new pool from a donated functional scatter.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.engine import EnginePlan, pack_linear, resolve_attn_backend
from repro_torch.engine.plan import resolve_plan
from repro_torch.models.attention import (
    attend_paged_decode,
    attend_paged_prefill,
)
from repro_torch.models.layers import (
    apply_rope,
    dense,
    init_embedding,
    init_linear,
    rms_norm,
    swiglu,
)

Params = Dict[str, Any]

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port serves the "
            "dense family")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """One dense layer's parameters, drawn on the generator's device."""
    dtype = _dtype(cfg)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    mlp = {"w_up": init_linear(gen, d, f, dtype),
           "w_down": init_linear(gen, f, d, dtype)}
    if cfg.mlp_gated:
        mlp["w_gate"] = init_linear(gen, d, f, dtype)
    zeros = torch.zeros((d,), dtype=dtype, device=gen.device)
    return {
        "ln1": zeros,
        "attn": {
            "wq": init_linear(gen, d, hq * dh, dtype, bias=cfg.qkv_bias),
            "wk": init_linear(gen, d, hkv * dh, dtype, bias=cfg.qkv_bias),
            "wv": init_linear(gen, d, hkv * dh, dtype, bias=cfg.qkv_bias),
            "wo": init_linear(gen, hq * dh, d, dtype),
        },
        "ln2": zeros.clone(),
        "mlp": mlp,
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                engine_bits: int = 0) -> Params:
    """Random parameters for ``cfg`` from ``gen`` (on the generator's
    device), the port's own initialisation with the JAX package's
    distributions: ``N(0, 1/d_in)`` linears, ``N(0, 0.02²)`` embedding,
    zero biases and norm scales.

    ``engine_bits`` packs each layer's linears as soon as the layer is
    drawn, so a full-width model never holds its dense weights at once.
    """
    _check_family(cfg)
    dtype = _dtype(cfg)
    embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
    layers = []
    for _ in range(cfg.n_layers):
        layer = init_layer(cfg, gen)
        if engine_bits:
            layer = _quantize_layer(layer, engine_bits)
        layers.append(layer)
    params: Params = {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                        dtype)
    return params


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer sliding window (0 = full attention)."""
    return [0 if cfg.is_global_layer(i) else cfg.sliding_window
            for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _mlp_apply(lp, x, cfg, plan):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(lp["mlp"], h, plan)


def embed_inputs(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """``(B, S)`` token ids -> ``(B, S, D)`` embeddings."""
    return params["embed"][tokens.long()]


def _lm_logits(params, x, cfg, plan):
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        # a plain large product outside any kernel, as the JAX package
        # leaves it to XLA
        return torch.matmul(h, params["embed"].to(h.dtype).t())
    return dense(params["lm_head"], h, plan)


def _quantize_kv(val: torch.Tensor):
    """Symmetric per-(…, head) int8 quantization of a K/V write:
    ``(..., Hkv, Dh)`` float -> (int8 of the same shape, ``(..., Hkv)``
    float32 scales).  The values are quantized with the float32 scale; the
    pool stores the scale as bf16."""
    vf = val.to(torch.float32)
    absmax = vf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    qv = torch.clamp(torch.round(vf / scale[..., None]), -127, 127)
    return qv.to(torch.int8), scale


def _scatter_targets(block_tables, positions, valid, page_size):
    """Physical (page, offset) targets of logical ``positions`` ((B,) at
    decode, (B, C) for a prefill chunk).  Invalid writes (idle lanes,
    chunk padding) go to the null page 0, which no block table maps."""
    nblk = block_tables.shape[1]
    blk = torch.clamp(positions // page_size, 0, nblk - 1)
    rows = torch.arange(block_tables.shape[0], device=positions.device)
    if positions.ndim == 2:
        rows = rows[:, None]
    pidx = torch.where(valid, block_tables[rows, blk].long(),
                       torch.zeros_like(blk))
    return pidx, positions % page_size


def _write_kv(pages, layer, pidx, poff, k, v):
    """Scatter one layer's new K/V (quantized on int8 pools) into the pool,
    in place."""
    if pages.quantized:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        pages.k[layer].index_put_((pidx, poff), kq)
        pages.v[layer].index_put_((pidx, poff), vq)
        pages.k_scale[layer].index_put_((pidx, poff),
                                        ks.to(pages.k_scale.dtype))
        pages.v_scale[layer].index_put_((pidx, poff),
                                        vs.to(pages.v_scale.dtype))
    else:
        pages.k[layer].index_put_((pidx, poff), k.to(pages.k.dtype))
        pages.v[layer].index_put_((pidx, poff), v.to(pages.v.dtype))


def _layer_pools(pages, layer):
    if pages.quantized:
        return (pages.k[layer], pages.v[layer], pages.k_scale[layer],
                pages.v_scale[layer])
    return pages.k[layer], pages.v[layer], None, None


def _resolve(eng, attn_backend, device):
    plan = resolve_plan(eng, device=device)
    if attn_backend is None and plan is not None:
        attn_backend = plan.attn_backend
    return plan, resolve_attn_backend(attn_backend, device)


# ---------------------------------------------------------------------------
# paged-KV serving: decode + chunked prefill against a page-table cache
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step_paged(
    params: Params,
    pages,                              # KVPages: k/v (L, P, page, Hkv, Dh)
    block_tables: torch.Tensor,         # (B, n_blocks) int32
    pos: torch.Tensor,                  # (B,) logical token count per lane
    active: torch.Tensor,               # (B,) bool — lanes decoding now
    tokens: torch.Tensor,               # (B, 1)
    cfg: ModelConfig,
    eng: Optional[EnginePlan] = None,
    attn_backend: Optional[str] = None,
) -> torch.Tensor:
    """One token of greedy decode over paged KV; returns logits
    ``(B, 1, V)``.  Inactive lanes write their K/V into the null page and
    their logits are meaningless.  ``pages`` is updated in place."""
    _check_family(cfg)
    plan, abk = _resolve(eng, attn_backend, tokens.device)
    b = tokens.shape[0]
    dh, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    x = embed_inputs(params, tokens)
    pos = pos.long()
    pidx, poff = _scatter_targets(block_tables, pos, active, pages.page_size)
    pos2 = pos[:, None]
    for layer, (lp, win) in enumerate(zip(params["layers"],
                                          _layer_windows(cfg))):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = dense(lp["attn"]["wq"], h, plan).reshape(b, 1, hq, dh)
        k = dense(lp["attn"]["wk"], h, plan).reshape(b, 1, hkv, dh)
        v = dense(lp["attn"]["wv"], h, plan).reshape(b, 1, hkv, dh)
        q = apply_rope(q, pos2, cfg.rope_theta)
        k = apply_rope(k, pos2, cfg.rope_theta)
        _write_kv(pages, layer, pidx, poff, k[:, 0], v[:, 0])
        kp, vp, ks, vs = _layer_pools(pages, layer)
        o = attend_paged_decode(q, kp, vp, block_tables, pos, win,
                                k_scale=ks, v_scale=vs, attn_backend=abk)
        x = x + dense(lp["attn"]["wo"], o.reshape(b, 1, hq * dh), plan)
        x = _mlp_apply(lp, x, cfg, plan)
    return _lm_logits(params, x, cfg, plan)


@torch.no_grad()
def prefill_chunk(
    params: Params,
    pages,                              # KVPages
    block_tables: torch.Tensor,         # (B, n_blocks) int32
    tokens: torch.Tensor,               # (B, C)
    pos0: torch.Tensor,                 # (B,) tokens already prefilled
    seq_lens: torch.Tensor,             # (B,) total valid after this chunk
    cfg: ModelConfig,
    eng: Optional[EnginePlan] = None,
    attn_backend: Optional[str] = None,
) -> torch.Tensor:
    """One batched chunk of prompt prefill against paged KV.

    Lane ``b`` contributes tokens for positions ``[pos0[b], seq_lens[b])``;
    chunk padding and idle lanes (``seq_lens == pos0``) write into the null
    page and their queries are ignored.  Attention sees the lane's whole
    resident prefix plus this chunk.  Returns the last valid token's
    logits ``(B, 1, V)``; ``pages`` is updated in place.
    """
    _check_family(cfg)
    plan, abk = _resolve(eng, attn_backend, tokens.device)
    b, c = tokens.shape
    dh, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    pos0, seq_lens = pos0.long(), seq_lens.long()
    positions = pos0[:, None] + torch.arange(c, device=tokens.device)[None]
    valid_q = positions < seq_lens[:, None]
    x = embed_inputs(params, tokens)
    pidx, poff = _scatter_targets(block_tables, positions, valid_q,
                                  pages.page_size)
    for layer, (lp, win) in enumerate(zip(params["layers"],
                                          _layer_windows(cfg))):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = dense(lp["attn"]["wq"], h, plan).reshape(b, c, hq, dh)
        k = dense(lp["attn"]["wk"], h, plan).reshape(b, c, hkv, dh)
        v = dense(lp["attn"]["wv"], h, plan).reshape(b, c, hkv, dh)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        _write_kv(pages, layer, pidx, poff, k, v)
        kp, vp, ks, vs = _layer_pools(pages, layer)
        o = attend_paged_prefill(q, kp, vp, block_tables, positions, pos0,
                                 seq_lens, win, k_scale=ks, v_scale=vs,
                                 attn_backend=abk)
        x = x + dense(lp["attn"]["wo"], o.reshape(b, c, hq * dh), plan)
        x = _mlp_apply(lp, x, cfg, plan)
    last = torch.clamp(seq_lens - pos0 - 1, 0, c - 1)
    h_last = x[torch.arange(b, device=x.device), last][:, None]
    return _lm_logits(params, h_last, cfg, plan)


# ---------------------------------------------------------------------------
# engine quantization
# ---------------------------------------------------------------------------


def _quantize_layer(layer: Params, bits: int) -> Params:
    out: Params = {}
    for key, val in layer.items():
        if key in _QUANT_KEYS and isinstance(val, dict) and "w" in val:
            out[key] = pack_linear(val["w"], bits, bias=val.get("bias"))
        elif isinstance(val, dict):
            out[key] = _quantize_layer(val, bits)
        else:
            out[key] = val
    return out


@torch.no_grad()
def quantize_params(params: Params, cfg: ModelConfig, bits: int = 8
                    ) -> Params:
    """Every linear of every layer becomes a :class:`PackedLinear`;
    embeddings and norms stay dense.  Already-packed linears pass
    through.  Packing runs layer by layer."""
    _check_family(cfg)
    out = dict(params)
    out["layers"] = [_quantize_layer(lp, bits) for lp in params["layers"]]
    if "lm_head" in params and "w" in params["lm_head"]:
        out["lm_head"] = pack_linear(params["lm_head"]["w"], bits,
                                     bias=params["lm_head"].get("bias"))
    return out
