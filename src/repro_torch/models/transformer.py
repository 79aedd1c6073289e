"""Decoder LM of the dense and ssm families.

Parameters are a plain dictionary::

    {"embed": (V, D), "final_norm": (D,),
     "layers": [{"ln1", "attn": {"wq", "wk", "wv", "wo"},
                 "ln2", "mlp": {"w_gate", "w_up", "w_down"}}, ...]}

for the dense family and ``"layers": [{"ln1", "ssm": {...}}, ...]`` for
the ssm family (``models/ssm.py``), with one entry per layer (the JAX
package stacks layers on a leading axis and scans; here the layer loop is
a Python loop, so every layer's window is a Python ``int``).  A linear is
``{"w": (K, N)[, "bias"]}`` or, after :func:`quantize_params`, an engine
:class:`~repro_torch.engine.PackedLinear`.

Two paths:

* the full-sequence path, :func:`forward` and the slots-layout cache path
  :func:`init_cache` / one-shot :func:`prefill` / :func:`decode_step`,
  for both families; at :data:`FLASH_THRESHOLD` tokens and more attention
  runs flash attention, and the ssm family runs the SSD scan, both as
  CUDA kernels on the ``cuda`` attention backend;
* paged serving, :func:`prefill_chunk` / :func:`decode_step_paged`, for
  the dense family.

:func:`prefill`, :func:`decode_step`, :func:`decode_step_paged` and
:func:`prefill_chunk` write caches and page pools **in place**
(``index_put_`` and slice assignment), where the JAX package returns new
arrays from donated functional updates.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import EnginePlan, pack_linear, resolve_attn_backend
from repro_torch.engine.plan import resolve_plan
from repro_torch.models.attention import (
    FLASH_THRESHOLD,
    attend_decode,
    attend_dense,
    attend_flash,
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
from repro_torch.models.ssm import (
    _ssm_run,
    init_ssm,
    ssm_decode_step,
    ssm_forward,
)

Params = Dict[str, Any]

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "in_proj", "out_proj")
_FULL_SEQUENCE = ("dense", "ssm")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig, families=("dense",)) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported on this path; it runs "
            f"the {' and '.join(families)} families")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """One layer's parameters, drawn on the generator's device."""
    dtype = _dtype(cfg)
    if cfg.family == "ssm":
        return {"ln1": torch.zeros((cfg.d_model,), dtype=dtype,
                                   device=gen.device),
                "ssm": init_ssm(cfg, gen, dtype)}
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
    _check_family(cfg, _FULL_SEQUENCE)
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


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """``(B, S)`` token ids -> ``(B, S, D)`` embeddings."""
    return params["embed"][tokens.long()]


def embed_inputs(params: Params, batch: Dict[str, torch.Tensor]):
    """Returns (x ``(B, S, D)``, positions ``(B, S)``): ``batch["tokens"]``
    embedded, and ``batch["positions"]`` when given, else ``0..S-1`` in
    every row."""
    x = _embed(params, batch["tokens"])
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    return x, positions


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
# full-sequence path: forward, slots-layout cache, one-shot prefill, decode
# ---------------------------------------------------------------------------


def _attn_apply(p, x, positions, cfg, plan, window, *, use_flash: bool,
                attn_backend: str, sequential: bool):
    """Full-sequence attention sub-block.  Returns (out, (k, v))."""
    b, s, _ = x.shape
    dh, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = dense(p["attn"]["wq"], h, plan).reshape(b, s, hq, dh)
    k = dense(p["attn"]["wk"], h, plan).reshape(b, s, hkv, dh)
    v = dense(p["attn"]["wv"], h, plan).reshape(b, s, hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if use_flash:
        o = attend_flash(q, k, v, positions, window,
                         attn_backend=attn_backend, sequential=sequential)
    else:
        o = attend_dense(q, k, v, positions, positions, window)
    o = dense(p["attn"]["wo"], o.reshape(b, s, hq * dh), plan)
    return x + o, (k, v)


def _sequence_setup(params, batch, cfg, eng, attn_backend):
    """Embeddings, positions, the plan and the sequence mixers' settings of
    :func:`forward` and :func:`prefill`: flash attention from
    :data:`FLASH_THRESHOLD` tokens, the kernels on the ``cuda`` backend."""
    _check_family(cfg, _FULL_SEQUENCE)
    x, positions = embed_inputs(params, batch)
    plan, abk = _resolve(eng, attn_backend, x.device)
    return x, positions, plan, dict(
        use_flash=x.shape[1] >= FLASH_THRESHOLD, attn_backend=abk,
        sequential=batch.get("positions") is None)


def forward(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    eng: Optional[EnginePlan] = None,
    return_hidden: bool = False,
    attn_backend: Optional[str] = None,
):
    """Full-sequence forward (scoring).  Returns (logits ``(B, S, V)``,
    aux loss) — or (hidden ``(B, S, D)``, aux loss) with ``return_hidden``.

    At :data:`FLASH_THRESHOLD` tokens and more, attention runs
    :func:`attend_flash`; the ``cuda`` attention backend (the default on a
    CUDA device) runs the flash and SSD-scan kernels, ``gather`` their
    plain versions.  The JAX package's ``remat`` and ``local_gather``
    options belong to training and to the sliding-window family, which are
    not ported.
    """
    x, positions, plan, mixers = _sequence_setup(params, batch, cfg, eng,
                                                 attn_backend)
    use_kernel = mixers["attn_backend"] == "cuda"
    if cfg.family == "dense":
        for lp, win in zip(params["layers"], _layer_windows(cfg)):
            x, _ = _attn_apply(lp, x, positions, cfg, plan, win, **mixers)
            x = _mlp_apply(lp, x, cfg, plan)
    else:
        for lp in params["layers"]:
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            x = x + ssm_forward(lp["ssm"], h, cfg, plan,
                                use_kernel=use_kernel)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return _lm_logits(params, x, cfg, plan), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               split_local: bool = False, stacked: bool = True,
               kv_bits: int = 0, device: DeviceLike = None) -> Params:
    """Decode cache in the slots layout, on ``device`` (None means the GPU).

    dense: ``k``/``v`` ``(L, B, max_len, Hkv, Dh)`` at full precision;
    ssm: ``conv`` ``(L, B, cw - 1, d_inner + 2N)`` and ``h`` ``(L, B, H, P,
    N)`` float32; both with ``pos`` ``(B,)`` int32.  The JAX package's int8
    (``kv_bits=8``), unstacked and ``split_local`` layouts are not ported
    and raise.
    """
    _check_family(cfg, _FULL_SEQUENCE)
    if kv_bits:
        raise NotImplementedError("init_cache(kv_bits=8): the int8 slots "
                                  "cache is not ported")
    if not stacked:
        raise NotImplementedError("init_cache(stacked=False): the unstacked "
                                  "layout is not ported")
    if split_local:
        raise NotImplementedError("init_cache(split_local=True): the "
                                  "window-capped local layout is not ported")
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    cache: Params = {"pos": torch.zeros((batch,), dtype=torch.int32,
                                        device=device)}
    if cfg.family == "dense":
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    else:
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        cache["conv"] = torch.zeros(
            (cfg.n_layers, batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
            device=device)
        cache["h"] = torch.zeros(
            (cfg.n_layers, batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
             cfg.ssm_state), dtype=torch.float32, device=device)
    return cache


@torch.no_grad()
def prefill(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    cache: Params,
    eng: Optional[EnginePlan] = None,
    attn_backend: Optional[str] = None,
):
    """Run the prompt through the model in one pass, filling the cache.

    Returns (last-token logits ``(B, 1, V)``, cache).  The cache's tensors
    are written **in place** (K/V rows ``[0, S)`` set and the rest zeroed,
    as the JAX package's padded copy has them; conv and h states
    replaced; ``pos`` set to S); the returned dictionary holds the same
    tensors.
    """
    x, positions, plan, mixers = _sequence_setup(params, batch, cfg, eng,
                                                 attn_backend)
    s = x.shape[1]
    if cfg.family == "dense":
        if s > cache["k"].shape[2]:
            raise ValueError(f"prefill: {s} prompt tokens exceed the cache's "
                             f"{cache['k'].shape[2]} slots")
        for layer, (lp, win) in enumerate(zip(params["layers"],
                                              _layer_windows(cfg))):
            x, (k, v) = _attn_apply(lp, x, positions, cfg, plan, win,
                                    **mixers)
            x = _mlp_apply(lp, x, cfg, plan)
            for name, val in (("k", k), ("v", v)):
                cache[name][layer, :, :s] = val.to(cache[name].dtype)
                cache[name][layer, :, s:] = 0
    else:
        use_kernel = mixers["attn_backend"] == "cuda"
        for layer, lp in enumerate(params["layers"]):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            y, conv, h_state = _ssm_run(lp["ssm"], h, cfg, plan, None, None,
                                        use_kernel=use_kernel)
            x = x + y
            cache["conv"][layer] = conv.to(cache["conv"].dtype)
            cache["h"][layer] = h_state
    cache["pos"].fill_(s)
    return _lm_logits(params, x[:, -1:], cfg, plan), dict(cache)


def _attn_decode_apply(p, x, cache_k, cache_v, pos, cfg, plan, window,
                       active=None):
    """One cached-attention sub-block for a single new token; writes the
    token's K/V into ``cache_k``/``cache_v`` ``(B, T, Hkv, Dh)`` in place
    at slot ``min(pos, T - 1)`` (lanes outside ``active`` rewrite the row
    they had) and attends the cache (the plain :func:`attend_decode`, as
    the JAX package leaves it to XLA)."""
    b = x.shape[0]
    dh, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = dense(p["attn"]["wq"], h, plan).reshape(b, 1, hq, dh)
    k = dense(p["attn"]["wk"], h, plan).reshape(b, 1, hkv, dh)
    v = dense(p["attn"]["wv"], h, plan).reshape(b, 1, hkv, dh)
    pos2 = pos[:, None]
    q = apply_rope(q, pos2, cfg.rope_theta)
    k = apply_rope(k, pos2, cfg.rope_theta)
    slot = torch.clamp(pos.long(), max=cache_k.shape[1] - 1)
    bidx = torch.arange(b, device=x.device)
    for cache_t, new in ((cache_k, k), (cache_v, v)):
        row = new[:, 0].to(cache_t.dtype)
        if active is not None:
            row = torch.where(active[:, None, None], row, cache_t[bidx, slot])
        cache_t[bidx, slot] = row
    o = attend_decode(q, cache_k, cache_v, pos, window)
    return x + dense(p["attn"]["wo"], o.reshape(b, 1, hq * dh), plan)


@torch.no_grad()
def decode_step(
    params: Params,
    cache: Params,
    tokens: torch.Tensor,                # (B, 1)
    cfg: ModelConfig,
    eng: Optional[EnginePlan] = None,
    attn_backend: Optional[str] = None,
    active: Optional[torch.Tensor] = None,   # (B,) bool
):
    """One token of autoregressive decode over the slots cache.  Returns
    (logits ``(B, 1, V)``, cache): the cache's tensors, ``pos`` included,
    are updated **in place** (so a captured CUDA graph of this step
    replays against the same storage) and the returned dictionary holds
    them.

    ``active``, when given, names the lanes that advance.  Every cache
    entry of the other lanes (their K/V row, conv and h states, ``pos``)
    is left bit-identical, as the JAX serving engine's ``_merge_cache``
    leaves a frozen slot, and their logits are meaningless.  The lanes
    are selected where the step writes: the K/V rows it overwrites, and
    the conv and h states, which it writes whole anyway."""
    _check_family(cfg, _FULL_SEQUENCE)
    plan, _ = _resolve(eng, attn_backend, tokens.device)
    pos = cache["pos"]
    x = _embed(params, tokens)
    if cfg.family == "dense":
        for layer, (lp, win) in enumerate(zip(params["layers"],
                                              _layer_windows(cfg))):
            x = _attn_decode_apply(lp, x, cache["k"][layer],
                                   cache["v"][layer], pos, cfg, plan, win,
                                   active)
            x = _mlp_apply(lp, x, cfg, plan)
    else:
        for layer, lp in enumerate(params["layers"]):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            y, conv, h_state = ssm_decode_step(
                lp["ssm"], h, cfg, cache["conv"][layer], cache["h"][layer],
                plan)
            x = x + y
            conv = conv.to(cache["conv"].dtype)
            if active is not None:
                conv = torch.where(active[:, None, None], conv,
                                   cache["conv"][layer])
                h_state = torch.where(active[:, None, None, None], h_state,
                                      cache["h"][layer])
            cache["conv"][layer] = conv
            cache["h"][layer] = h_state
    logits = _lm_logits(params, x, cfg, plan)
    pos.add_(1 if active is None else active.to(pos.dtype))
    return logits, dict(cache)


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
    x = _embed(params, tokens)
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
    x = _embed(params, tokens)
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
    _check_family(cfg, _FULL_SEQUENCE)
    out = dict(params)
    out["layers"] = [_quantize_layer(lp, bits) for lp in params["layers"]]
    if "lm_head" in params and "w" in params["lm_head"]:
        out["lm_head"] = pack_linear(params["lm_head"]["w"], bits,
                                     bias=params["lm_head"].get("bias"))
    return out
