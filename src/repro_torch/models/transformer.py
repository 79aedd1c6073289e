"""Decoder LM of the six families: dense, vlm, audio, moe, ssm and
hybrid.

Parameters are a plain dictionary::

    {"embed": (V, D), "final_norm": (D,),
     "layers": [{"ln1", "attn": {"wq", "wk", "wv", "wo"},
                 "ln2", "mlp": {"w_gate", "w_up", "w_down"}}, ...]}

for the dense family and its two front-end variants: vlm (precomputed
image embeddings ``img_embeds`` ``(B, S_img, D)`` prepended to the text
stream by :func:`forward` and :func:`prefill`, and cut off their output),
and audio (``embed`` ``(K, V, D)``, one table per codebook, tokens ``(B, S,
K)`` whose K embeddings are summed, and an ``lm_head`` of ``V·K`` outputs
read as ``(B, S, K, V)`` logits).  The moe family has ``"moe": {"router",
"w_gate", "w_up", "w_down"[, "shared"]}`` (``models/moe.py``: stacked
experts) in place of ``"mlp"``; the ssm family ``"layers": [{"ln1", "ssm":
{...}}, ...]`` (``models/ssm.py``); the hybrid family (zamba2) ssm layers
plus one ``"shared_attn": {"ln1", "attn", "ln2", "mlp"}`` block whose
weights every ``attn_every``-th layer applies after its ssm block (``n_layers
// attn_every`` sites, each with its own K/V).  There is one entry per
layer (the JAX package stacks layers on a leading axis and scans; here the
layer loop is a Python loop, so every layer's window and every site index
is a Python ``int``).  A linear is ``{"w": (K, N)[, "bias"]}`` (an expert
stack a ``(E, K, N)`` tensor) or, after :func:`quantize_params`, an engine
:class:`~repro_torch.engine.PackedLinear`.

Two paths:

* the full-sequence path, :func:`forward` and the slots-layout cache path
  :func:`init_cache` / one-shot :func:`prefill` / :func:`decode_step`,
  for the six families; at :data:`FLASH_THRESHOLD` tokens and more
  attention runs flash attention, and the ssm and hybrid families' ssm
  layers run the SSD scan, both as CUDA kernels on the ``cuda`` attention
  backend.  The training loss is :func:`forward` (``remat``, the plain
  ``gather`` mixers: the kernels have no backward pass) and
  :func:`chunked_ce`; the JAX package's decode-only cache layouts (int8,
  unstacked, split local/global) run :func:`decode_step`;
* paged serving, :func:`prefill_chunk` / :func:`decode_step_paged`, for
  the families with a pageable KV cache (dense, vlm, audio and moe, the
  JAX package's ``PAGED_FAMILIES``); a vlm model serves text there, as in
  the JAX package.

The moe family's steps take ``expert_counts``, an ``(L, E)`` int32 tensor
that each MoE layer fills in place with the rows each expert computed, so
a step's touched experts can be read after it (a captured graph refills
it on every replay).

:func:`prefill`, :func:`decode_step`, :func:`decode_step_paged` and
:func:`prefill_chunk` write caches and page pools **in place**
(``index_put_`` and slice assignment), where the JAX package returns new
arrays from donated functional updates.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import FAMILIES, PAGED_FAMILIES, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.collectives import copy_to, gather_from, sum_over
from repro_torch.dist.sharding import _ROW
from repro_torch.engine import (
    EnginePlan,
    as_packed,
    is_packed,
    pack_linear,
    resolve_attn_backend,
)
from repro_torch.engine.plan import resolve_plan
from repro_torch.engine.sharded import sharded_paged_attention
from repro_torch.models.attention import (
    FLASH_THRESHOLD,
    attend_decode,
    attend_decode_quant,
    attend_decode_ring,
    attend_dense,
    attend_flash,
    attend_local_gather,
)
from repro_torch.models.layers import (
    apply_rope,
    dense,
    init_embedding,
    init_linear,
    rms_norm,
    row_dense,
    swiglu,
)
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.ssm import (
    _ssm_run,
    init_ssm,
    ssm_decode_step,
    ssm_forward,
)

Params = Dict[str, Any]

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "in_proj", "out_proj", "lm_head")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig, families=PAGED_FAMILIES) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported on this path; it runs "
            f"the {' and '.join(families)} families")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_attn(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": init_linear(gen, d, hq * dh, dtype, bias=cfg.qkv_bias),
        "wk": init_linear(gen, d, hkv * dh, dtype, bias=cfg.qkv_bias),
        "wv": init_linear(gen, d, hkv * dh, dtype, bias=cfg.qkv_bias),
        "wo": init_linear(gen, hq * dh, d, dtype),
    }


def _init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    mlp = {"w_up": init_linear(gen, d, f, dtype),
           "w_down": init_linear(gen, f, d, dtype)}
    if cfg.mlp_gated:
        mlp["w_gate"] = init_linear(gen, d, f, dtype)
    return mlp


def _norm(cfg: ModelConfig, gen: torch.Generator, dtype) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)


def init_layer(cfg: ModelConfig, gen: torch.Generator,
               engine_bits: int = 0) -> Params:
    """One layer's parameters, drawn on the generator's device; a moe
    layer's experts packed to ``engine_bits`` as each is drawn."""
    dtype = _dtype(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return {"ln1": _norm(cfg, gen, dtype),
                "ssm": init_ssm(cfg, gen, dtype)}
    layer = {"ln1": _norm(cfg, gen, dtype),
             "attn": _init_attn(cfg, gen, dtype),
             "ln2": _norm(cfg, gen, dtype)}
    if cfg.family == "moe":
        layer["moe"] = init_moe(cfg, gen, dtype, engine_bits)
    else:
        layer["mlp"] = _init_mlp(cfg, gen, dtype)
    return layer


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                engine_bits: int = 0) -> Params:
    """Random parameters for ``cfg`` from ``gen`` (on the generator's
    device), the port's own initialisation with the JAX package's
    distributions: ``N(0, 1/d_in)`` linears, ``N(0, 0.02²)`` embedding,
    zero biases and norm scales.

    ``engine_bits`` packs each layer's linears, the hybrid family's
    shared block and an untied ``lm_head`` as soon as they are drawn, so
    a full-width model never holds its dense weights at once.  The audio family draws one
    embedding table per codebook and an ``lm_head`` of ``V·K`` outputs.
    """
    _check_family(cfg, FAMILIES)
    dtype = _dtype(cfg)
    if cfg.family == "audio":
        embed = torch.stack([
            init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
            for _ in range(cfg.n_codebooks)])
    else:
        embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
    layers = []
    for _ in range(cfg.n_layers):
        layer = init_layer(cfg, gen, engine_bits)
        if engine_bits:
            layer = _quantize_layer(layer, engine_bits)
        layers.append(layer)
    params: Params = {
        "embed": embed,
        "layers": layers,
        "final_norm": _norm(cfg, gen, dtype),
    }
    if cfg.family == "hybrid" and cfg.attn_every:
        shared = {"ln1": _norm(cfg, gen, dtype),
                  "attn": _init_attn(cfg, gen, dtype),
                  "ln2": _norm(cfg, gen, dtype),
                  "mlp": _init_mlp(cfg, gen, dtype)}
        if engine_bits:
            shared = _quantize_layer(shared, engine_bits)
        params["shared_attn"] = shared
    if not cfg.tie_embeddings:
        head = init_linear(gen, cfg.d_model,
                           cfg.vocab_size * cfg.n_codebooks, dtype)
        if engine_bits:
            head = pack_linear(head["w"], engine_bits, bias=head.get("bias"),
                               partition=_partition("lm_head"))
        params["lm_head"] = head
    return params


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer sliding window (0 = full attention)."""
    return [0 if cfg.is_global_layer(i) else cfg.sliding_window
            for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _mlp_apply(lp, x, cfg, plan, view=None):
    group = view.mlp_group if view else None
    h = copy_to(rms_norm(x, lp["ln2"], cfg.norm_eps), group)
    down = functools.partial(row_dense, plan=plan, group=group)
    return x + swiglu(lp["mlp"], h, plan, down)


def _moe_apply(lp, x, cfg, plan, counts=None, view=None):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, aux = moe_block(lp["moe"], h, cfg, plan, counts, view)
    return x + y, aux


def _ffn_apply(lp, x, cfg, plan, counts=None, view=None):
    """A layer's second sub-block: the MoE block (with its aux loss) in a
    moe layer, the MLP (aux None) otherwise.  ``counts``: the MoE block's
    ``(E,)`` rows-per-expert output; ``view``: a mesh rank's
    :class:`RankView`."""
    if "moe" in lp:
        return _moe_apply(lp, x, cfg, plan, counts, view)
    return _mlp_apply(lp, x, cfg, plan, view), None


def _layer_counts(expert_counts, layer):
    return None if expert_counts is None else expert_counts[layer]


def _embed(params: Params, tokens: torch.Tensor,
           cfg: ModelConfig, view=None) -> torch.Tensor:
    """``(B, S)`` token ids -> ``(B, S, D)`` embeddings; for the audio
    family ``(B, S, K)`` ids, the K codebooks' embeddings summed in
    codebook order, as the JAX package sums them.  On a mesh rank whose
    table holds a slice of the vocabulary rows (axis −2), each rank looks
    up the ids it holds, zeroes the rest, and the model group sums them:
    exactly, since each row is held by one rank; the audio family's K
    lookups are summed over the group one codebook apiece and then over
    the codebooks in codebook order, so the sum is one device's bit for
    bit."""
    if view is not None and view.vocab_group is not None:
        return _embed_sharded(params["embed"], tokens, cfg, view)
    if cfg.family == "audio":
        tokens = tokens.long()
        return sum(params["embed"][k][tokens[..., k]]
                   for k in range(cfg.n_codebooks))
    return params["embed"][tokens.long()]


def _embed_sharded(table, tokens, cfg, view):
    """:func:`_embed` on a rank holding rows ``[vocab_lo, vocab_lo +
    rows)`` of each table."""
    audio = cfg.family == "audio"
    tables = table if audio else table[None]
    ids = tokens.long() - view.vocab_lo
    if not audio:
        ids = ids[..., None]
    rows = tables.shape[1]
    held = (ids >= 0) & (ids < rows)
    ids = torch.clamp(ids, 0, rows - 1)
    x = torch.stack([tables[k][ids[..., k]] for k in range(ids.shape[-1])],
                    dim=-2)                                 # (..., K, D)
    x = sum_over(torch.where(held[..., None], x,
                             torch.zeros((), dtype=x.dtype,
                                         device=x.device)),
                 view.vocab_group)
    if not audio:
        return x[..., 0, :]
    return sum(x[..., k, :] for k in range(cfg.n_codebooks))


def _image_tokens(batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> int:
    """Image positions prepended to the text stream (vlm with
    ``img_embeds``), else 0."""
    if cfg.family == "vlm" and "img_embeds" in batch:
        return batch["img_embeds"].shape[1]
    return 0


def embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, view=None):
    """Returns (x ``(B, S, D)``, positions ``(B, S)``): ``batch["tokens"]``
    embedded (for a vlm with ``batch["img_embeds"]`` ``(B, S_img, D)``,
    those prepended, so S counts both), and ``batch["positions"]`` when
    given, else ``0..S-1`` in every row.  ``view``: a mesh rank's
    :class:`RankView` (its vocabulary rows)."""
    x = _embed(params, batch["tokens"], cfg, view)
    if _image_tokens(batch, cfg):
        x = torch.cat([batch["img_embeds"].to(x.dtype), x], dim=1)
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    return x, positions


def _lm_logits(params, x, cfg, plan, view=None):
    """``(B, S, V)`` logits, ``(B, S, K, V)`` for the audio family.  On a
    mesh rank whose head holds a slice of the vocabulary (the tied
    embedding's rows, or an untied head's column-parallel slice), the
    model group gathers the slices to full width before anything reads
    them (under autograd the head's input passes through ``copy_to`` and
    each rank keeps its slice of the logits' gradient)."""
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if view is not None:
        h = copy_to(h, view.head_group)
    if cfg.tie_embeddings:
        # a plain large product outside any kernel, as the JAX package
        # leaves it to XLA
        logits = torch.matmul(h, params["embed"].to(h.dtype).t())
    else:
        logits = dense(params["lm_head"], h, plan)
    if view is not None and view.head_group is not None:
        logits = gather_from(logits, view.head_group, dim=-1)
    if cfg.family == "audio":
        logits = logits.reshape(*logits.shape[:2], cfg.n_codebooks,
                                cfg.vocab_size)
    return logits


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


def _resolve(eng, attn_backend, device, mesh=None):
    plan = resolve_plan(eng, device=device, mesh=mesh)
    if attn_backend is None and plan is not None:
        attn_backend = plan.attn_backend
    return plan, resolve_attn_backend(attn_backend, device)


# ---------------------------------------------------------------------------
# full-sequence path: forward, slots-layout cache, one-shot prefill, decode
# ---------------------------------------------------------------------------


def _attn_apply(p, x, positions, cfg, plan, window, *, use_flash: bool,
                attn_backend: str, sequential: bool,
                local_gather: bool = False, view=None):
    """Full-sequence attention sub-block.  Returns (out, (k, v)).
    ``local_gather``: a windowed layer runs :func:`attend_local_gather`.
    ``view``: a mesh rank's :class:`RankView`: the rank's heads, and
    ``wo``'s partials summed over its attention group."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    hq, hkv = (view.hq, view.hkv) if view else (cfg.n_heads, cfg.n_kv_heads)
    group = view.attn_group if view else None
    h = copy_to(rms_norm(x, p["ln1"], cfg.norm_eps), group)
    q = dense(p["attn"]["wq"], h, plan).reshape(b, s, hq, dh)
    k = dense(p["attn"]["wk"], h, plan).reshape(b, s, hkv, dh)
    v = dense(p["attn"]["wv"], h, plan).reshape(b, s, hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if local_gather and window > 0:
        o = attend_local_gather(q, k, v, positions, window)
    elif use_flash:
        o = attend_flash(q, k, v, positions, window,
                         attn_backend=attn_backend, sequential=sequential)
    else:
        o = attend_dense(q, k, v, positions, positions, window)
    o = row_dense(p["attn"]["wo"], o.reshape(b, s, hq * dh), plan, group)
    return x + o, (k, v)


def _sequence_setup(params, batch, cfg, eng, attn_backend, view, mesh):
    """Embeddings, positions, the plan and the sequence mixers' settings of
    :func:`forward` and :func:`prefill`: flash attention from
    :data:`FLASH_THRESHOLD` tokens, the kernels on the ``cuda`` backend,
    the rank's heads (``view``)."""
    _check_family(cfg, FAMILIES)
    x, positions = embed_inputs(params, batch, cfg, view)
    plan, abk = _resolve(eng, attn_backend, x.device, mesh)
    return x, positions, plan, dict(
        use_flash=x.shape[1] >= FLASH_THRESHOLD, attn_backend=abk,
        sequential=batch.get("positions") is None, view=view)


def _sequence_view(params, cfg, mesh, layer0=None) -> "RankView":
    """:func:`rank_view` for a full-sequence pass over the rank's data
    shard of a batch: with more than one data shard, the shards' group,
    over which a moe layer takes the whole batch's aux loss."""
    view = rank_view(params, cfg, mesh, layer0=layer0)
    if mesh is not None:
        daxes = mesh.data_axes()
        n = mesh.count(daxes)
        if n > 1:
            view = view._replace(data_group=mesh.group(daxes), data_count=n)
    return view


def _site(cfg: ModelConfig, layer: int) -> Optional[int]:
    """The hybrid family's shared-attention site after ``layer`` (its
    index into the sites' K/V), or None where the block does not apply."""
    every = cfg.attn_every
    if cfg.family != "hybrid" or not every or (layer + 1) % every:
        return None
    return (layer + 1) // every - 1


def _remat(fn, remat: str):
    """``fn`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) unless ``remat == "none"``
    or no gradient is being recorded, where it would change nothing."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def forward(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    eng: Optional[EnginePlan] = None,
    return_hidden: bool = False,
    attn_backend: Optional[str] = None,
    local_gather: bool = False,
    remat: str = "block",
    mesh=None,
    gather=None,
):
    """Full-sequence forward (scoring).  Returns (logits ``(B, S, V)``, or
    ``(B, S, K, V)`` for the audio family, aux loss) — or (hidden ``(B,
    S, D)``, aux loss) with ``return_hidden``.  The aux loss is the moe
    family's router loss summed over layers (a float32 zero for the
    others).  A vlm batch with ``img_embeds`` runs them ahead of the text,
    and the output covers the text positions only.

    At :data:`FLASH_THRESHOLD` tokens and more, attention runs
    :func:`attend_flash`; the ``cuda`` attention backend (the default on a
    CUDA device) runs the flash and SSD-scan kernels, ``gather`` their
    plain versions.  ``local_gather``: for a config with both local and
    global layers (``sliding_window`` and ``global_every``, gemma3), every
    local layer runs :func:`attend_local_gather` (S a multiple of the
    window), as the JAX package's unscanned layer loop does; other configs
    ignore it, as JAX's scan does.

    ``remat`` (training): unless ``"none"``, each layer's body is
    checkpointed (``torch.utils.checkpoint``, non-reentrant), its
    activations recomputed in the backward pass, as the JAX package wraps
    its scanned body in ``jax.checkpoint``.  Without autograd recording it
    changes nothing.  The kernels refuse inputs that require grad: a
    training loss runs ``attn_backend="gather"``.

    ``mesh``: this rank's mesh.  ``params`` are then the rank's shards
    (``dist.sharding.serve_param_specs`` / ``local_shard``: whole heads,
    experts over ``model``, SSM blocks whole) and ``batch`` its data
    shard (``batch_shardings``); attention, flash included, runs at the
    rank's heads, the row-parallel ``wo`` / ``w_down`` sums, the
    vocabulary's lookups and logits and a MoE layer's combine cross the
    model group through the differentiable collectives, and the moe
    family's aux loss is the whole batch's (a mean over the data
    shards).  The output covers the rank's rows at full width.  Packed
    weights on a mesh run the ``sharded`` backend
    (``EngineConfig(sharded=True)``, resolved here with the mesh).

    ``gather`` (FSDP training, ``train.trainer``): ``params["layers"]``
    hold the rank's storage shards, and ``gather(lp)`` gathers a layer's
    leaves to the placement above inside the layer's body, so that remat
    gathers them again in the backward pass; ``gather.shapes(lp)`` gives
    the gathered shapes, which the rank's view reads.
    """
    view = _sequence_view(params, cfg, mesh,
                          gather.shapes(params["layers"][0])
                          if gather is not None else None)
    x, positions, plan, mixers = _sequence_setup(params, batch, cfg, eng,
                                                 attn_backend, view, mesh)
    use_kernel = mixers["attn_backend"] == "cuda"
    local_gather = (local_gather and cfg.sliding_window > 0
                    and cfg.global_every > 0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in PAGED_FAMILIES:
        def body(x, lp, win):
            if gather is not None:
                lp = gather(lp)
            x, _ = _attn_apply(lp, x, positions, cfg, plan, win,
                               local_gather=local_gather, **mixers)
            return _ffn_apply(lp, x, cfg, plan, view=view)

        step = _remat(body, remat)
        for lp, win in zip(params["layers"], _layer_windows(cfg)):
            x, a = step(x, lp, win)
            if a is not None:
                aux = aux + a
    else:
        shared = params.get("shared_attn")

        def body(x, lp, layer):
            if gather is not None:
                lp = gather(lp)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            x = x + ssm_forward(lp["ssm"], h, cfg, plan,
                                use_kernel=use_kernel)
            if shared is not None and _site(cfg, layer) is not None:
                x, _ = _attn_apply(shared, x, positions, cfg, plan, 0,
                                   **mixers)
                x = _mlp_apply(shared, x, cfg, plan, view)
            return x

        step = _remat(body, remat)
        for layer, lp in enumerate(params["layers"]):
            x = step(x, lp, layer)
    x = x[:, _image_tokens(batch, cfg):]
    if return_hidden:
        return x, aux
    return _lm_logits(params, x, cfg, plan, view), aux


def loss_fn(logits: torch.Tensor, labels: torch.Tensor,
            aux=0.0) -> torch.Tensor:
    """Token-mean cross entropy (+ router aux).  ``labels``: int, the
    logits' shape without the vocab axis."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return torch.mean(nll) + aux


def chunked_ce(params: Params, hidden: torch.Tensor, labels: torch.Tensor,
               cfg: ModelConfig, eng: Optional[EnginePlan] = None,
               chunk: int = 512, aux=0.0, mesh=None) -> torch.Tensor:
    """Cross entropy with the LM head applied per sequence chunk of
    ``chunk`` positions: live logits are ``(B, chunk, V)`` instead of
    ``(B, S, V)``, and each chunk's head and softmax run under
    ``torch.utils.checkpoint`` (recomputed in the backward pass), as the
    JAX package's ``jax.checkpoint`` scan body.  Equal to
    ``loss_fn(_lm_logits(hidden))``, which it runs instead when S is not a
    multiple of the chunk.  ``mesh``: as in :func:`forward` (the rank's
    rows, their token mean)."""
    plan = resolve_plan(eng, device=hidden.device, mesh=mesh)
    view = rank_view(params, cfg, mesh)
    b, s = hidden.shape[:2]
    chunk = min(chunk, s)
    if s % chunk:
        return loss_fn(_lm_logits(params, hidden, cfg, plan, view), labels,
                       aux)

    def body(hc, lc):
        logits = _lm_logits(params, hc, cfg, plan, view)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        return -torch.gather(logp, -1, lc.long()[..., None]).sum()

    step = _remat(body, "block")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        total = total + step(hidden[:, c0:c0 + chunk],
                             labels[:, c0:c0 + chunk])
    return total / labels.numel() + aux


def _split_local(cfg: ModelConfig, split_local: bool) -> bool:
    """Whether a cache asked for ``split_local`` gets the local/global
    split: only a config with both windowed and global layers."""
    return split_local and cfg.sliding_window > 0 and cfg.global_every > 0


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               split_local: bool = False, stacked: bool = True,
               kv_bits: int = 0, device: DeviceLike = None,
               n_kv_heads: Optional[int] = None) -> Params:
    """Decode cache in the slots layout, on ``device`` (None means the GPU).
    ``n_kv_heads``: the KV heads a mesh rank holds (default all of
    ``cfg.n_kv_heads``); ``batch`` is then the rank's lanes.

    dense, vlm, audio and moe: ``k``/``v`` ``(L, B, max_len, Hkv, Dh)`` (a
    vlm prompt's image positions count towards max_len);
    ssm: ``conv`` ``(L, B, cw - 1, d_inner + 2N)`` and ``h`` ``(L, B, H, P,
    N)`` float32; hybrid: those, and ``k``/``v`` ``(n_layers // attn_every,
    B, max_len, Hkv, Dh)`` for the shared block's sites; all with ``pos``
    ``(B,)`` int32.

    The JAX package's three other layouts, decode-only
    (:func:`prefill` refuses them):

    * ``kv_bits=8`` (dense, vlm, audio, moe): ``k``/``v`` int8 with
      bfloat16 per-(token, head) ``k_scale``/``v_scale`` ``(L, B, max_len,
      Hkv)``; :func:`decode_step` quantizes each new token's K/V;
    * ``stacked=False``: every per-layer (per-site) entry is a tuple of
      ``L`` separate tensors instead of one ``(L, ...)`` tensor;
    * ``split_local=True`` for a config with both windowed and global
      layers (``sliding_window`` and ``global_every``, gemma3): full-length
      ``k_global``/``v_global`` for the global layers and window-sized ring
      buffers ``k_local``/``v_local`` ``(n_local, B, sliding_window, Hkv,
      Dh)`` for the others (other configs get the uniform cache, as in
      JAX).

    ``kv_bits=8`` applies to the attention families' uniform cache; with
    ``split_local`` or on the ssm / hybrid families (where the JAX
    package would cast the conv state and the split cache to int8 with no
    scales) it raises.
    """
    _check_family(cfg, FAMILIES)
    split = _split_local(cfg, split_local)
    if kv_bits and (split or cfg.family not in PAGED_FAMILIES):
        raise ValueError(
            "init_cache(kv_bits=8) quantizes the uniform K/V cache of the "
            f"{', '.join(PAGED_FAMILIES)} families; family {cfg.family!r}"
            f"{' with split_local' if split else ''} has no int8 layout")
    if kv_bits not in (0, 8):
        raise ValueError(f"kv_bits must be 0/8, got {kv_bits}")
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    kv_dtype = torch.int8 if kv_bits else dtype
    cache: Params = {"pos": torch.zeros((batch,), dtype=torch.int32,
                                        device=device)}

    def per_layer(n, shape, dt):
        if stacked:
            return torch.zeros((n,) + shape, dtype=dt, device=device)
        return tuple(torch.zeros(shape, dtype=dt, device=device)
                     for _ in range(n))

    kv = (cfg.n_kv_heads if n_kv_heads is None else n_kv_heads,
          cfg.resolved_head_dim)
    if split:
        n_glob = sum(cfg.is_global_layer(i) for i in range(cfg.n_layers))
        n_loc = cfg.n_layers - n_glob
        for name, n, t in (("global", n_glob, max_len),
                           ("local", n_loc, cfg.sliding_window)):
            cache[f"k_{name}"] = per_layer(n, (batch, t) + kv, dtype)
            cache[f"v_{name}"] = per_layer(n, (batch, t) + kv, dtype)
        return cache
    kv_sets = (cfg.n_layers if cfg.family in PAGED_FAMILIES
               else cfg.n_layers // cfg.attn_every
               if cfg.family == "hybrid" and cfg.attn_every else 0)
    if kv_sets:
        cache["k"] = per_layer(kv_sets, (batch, max_len) + kv, kv_dtype)
        cache["v"] = per_layer(kv_sets, (batch, max_len) + kv, kv_dtype)
        if kv_bits:
            for name in ("k_scale", "v_scale"):
                cache[name] = per_layer(kv_sets, (batch, max_len, kv[0]),
                                        torch.bfloat16)
    if cfg.family in ("ssm", "hybrid"):
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        cache["conv"] = per_layer(
            cfg.n_layers, (batch, cfg.conv_width - 1, conv_ch), dtype)
        cache["h"] = per_layer(
            cfg.n_layers, (batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), torch.float32)
    return cache


def _decode_only_layout(cache: Params) -> Optional[str]:
    """The name of a decode-only cache layout, or None for the stacked
    full-precision one."""
    if "k_global" in cache:
        return "split_local=True"
    if "k_scale" in cache:
        return "kv_bits=8"
    if isinstance(cache.get("k", cache.get("conv")), tuple):
        return "stacked=False"
    return None


@torch.no_grad()
def prefill(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    cache: Params,
    eng: Optional[EnginePlan] = None,
    attn_backend: Optional[str] = None,
    mesh=None,
):
    """Run the prompt through the model in one pass, filling the cache.

    Returns (last-token logits ``(B, 1, V)``, ``(B, 1, K, V)`` for the
    audio family, cache).  The cache's tensors are written **in place**
    (K/V rows ``[0, S)`` set and the rest zeroed, as the JAX package's
    padded copy has them — for the hybrid family at each shared-attention
    site; conv and h states replaced; ``pos`` set to S); the returned
    dictionary holds the same tensors.  A vlm batch with ``img_embeds``
    counts its image positions in S and fills their K/V too.

    ``mesh``: this rank's mesh, as in :func:`forward`; ``cache`` holds
    the rank's rows and KV heads (``init_cache(n_kv_heads=)``, the
    shards :func:`decode_step` reads), and the logits are full width.
    """
    layout = _decode_only_layout(cache)
    if layout is not None:
        raise NotImplementedError(
            f"prefill: the {layout} cache is decode-only, as in the JAX "
            "package (its prefill reads one stacked full-precision K/V and "
            "would cast to int8 without scales); decode the prompt from an "
            "empty cache with decode_step")
    view = rank_view(params, cfg, mesh)
    x, positions, plan, mixers = _sequence_setup(params, batch, cfg, eng,
                                                 attn_backend, view, mesh)
    s = x.shape[1]
    if "k" in cache and s > cache["k"].shape[2]:
        raise ValueError(f"prefill: {s} prompt tokens exceed the cache's "
                         f"{cache['k'].shape[2]} slots")

    def put_kv(index, k, v):
        for name, val in (("k", k), ("v", v)):
            cache[name][index, :, :s] = val.to(cache[name].dtype)
            cache[name][index, :, s:] = 0

    if cfg.family in PAGED_FAMILIES:
        for layer, (lp, win) in enumerate(zip(params["layers"],
                                              _layer_windows(cfg))):
            x, (k, v) = _attn_apply(lp, x, positions, cfg, plan, win,
                                    **mixers)
            x, _ = _ffn_apply(lp, x, cfg, plan, view=view)
            put_kv(layer, k, v)
    else:
        use_kernel = mixers["attn_backend"] == "cuda"
        shared = params.get("shared_attn")
        for layer, lp in enumerate(params["layers"]):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            y, conv, h_state = _ssm_run(lp["ssm"], h, cfg, plan, None, None,
                                        use_kernel=use_kernel)
            x = x + y
            cache["conv"][layer] = conv.to(cache["conv"].dtype)
            cache["h"][layer] = h_state
            site = _site(cfg, layer)
            if shared is not None and site is not None:
                x, (k, v) = _attn_apply(shared, x, positions, cfg, plan, 0,
                                        **mixers)
                x = _mlp_apply(shared, x, cfg, plan, view)
                put_kv(site, k, v)
    x = x[:, _image_tokens(batch, cfg):]
    cache["pos"].fill_(s)
    return _lm_logits(params, x[:, -1:], cfg, plan, view), dict(cache)


def _decode_qkv(p, x, pos, cfg, plan, view):
    """The new token's rotated q ``(B, 1, Hq, Dh)`` and k, v ``(B, Hkv,
    Dh)``, at the rank's head counts (``view``)."""
    b = x.shape[0]
    dh, hq, hkv = cfg.resolved_head_dim, view.hq, view.hkv
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = dense(p["attn"]["wq"], h, plan).reshape(b, 1, hq, dh)
    k = dense(p["attn"]["wk"], h, plan).reshape(b, 1, hkv, dh)
    v = dense(p["attn"]["wv"], h, plan).reshape(b, 1, hkv, dh)
    pos2 = pos[:, None]
    return (apply_rope(q, pos2, cfg.rope_theta),
            apply_rope(k, pos2, cfg.rope_theta)[:, 0], v[:, 0])


def _write_rows(cache_t, slot, row, active):
    """``cache_t[b, slot[b]] = row[b]`` in place (lanes outside ``active``
    rewrite the row they had)."""
    bidx = torch.arange(row.shape[0], device=row.device)
    row = row.to(cache_t.dtype)
    if active is not None:
        shape = (-1,) + (1,) * (row.ndim - 1)
        row = torch.where(active.reshape(shape), row, cache_t[bidx, slot])
    cache_t[bidx, slot] = row


def _attn_out(p, x, o, cfg, plan, view):
    """``x`` plus ``wo`` of the rank's heads, summed over the model group
    when ``wo`` is row-parallel."""
    b = x.shape[0]
    return x + row_dense(p["attn"]["wo"],
                         o.reshape(b, 1, view.hq * cfg.resolved_head_dim),
                         plan, view.attn_group)


def _attn_decode_apply(p, x, cache_k, cache_v, pos, cfg, plan, window,
                       view, active=None, scales=None):
    """One cached-attention sub-block for a single new token; writes the
    token's K/V into ``cache_k``/``cache_v`` ``(B, T, Hkv, Dh)`` in place
    at slot ``min(pos, T - 1)`` and attends the cache (the plain
    :func:`attend_decode`, as the JAX package leaves it to XLA).

    ``scales``: the int8 cache's ``(k_scale, v_scale)`` ``(B, T, Hkv)``
    bfloat16: the token's K/V are quantized per (token, head) and the
    cache read through :func:`attend_decode_quant`.  ``view``: the
    rank's heads and groups (:func:`rank_view`)."""
    q, k, v = _decode_qkv(p, x, pos, cfg, plan, view)
    slot = torch.clamp(pos.long(), max=cache_k.shape[1] - 1)
    if scales is None:
        _write_rows(cache_k, slot, k, active)
        _write_rows(cache_v, slot, v, active)
        o = attend_decode(q, cache_k, cache_v, pos, window)
    else:
        for cache_t, scale_t, val in ((cache_k, scales[0], k),
                                      (cache_v, scales[1], v)):
            codes, scale = _quantize_kv(val)
            _write_rows(cache_t, slot, codes, active)
            _write_rows(scale_t, slot, scale, active)
        o = attend_decode_quant(q, cache_k, cache_v, scales[0], scales[1],
                                pos, window)
    return _attn_out(p, x, o, cfg, plan, view)


def _attn_decode_apply_ring(p, x, ring_k, ring_v, pos, cfg, plan, view,
                            active=None):
    """The window-capped local layer of a ``split_local`` cache: the
    token's K/V go to ring slot ``pos % W`` and the ring is attended by
    :func:`attend_decode_ring`."""
    q, k, v = _decode_qkv(p, x, pos, cfg, plan, view)
    slot = pos.long() % ring_k.shape[1]
    _write_rows(ring_k, slot, k, active)
    _write_rows(ring_v, slot, v, active)
    return _attn_out(p, x, attend_decode_ring(q, ring_k, ring_v, pos), cfg,
                     plan, view)


def _layer_scales(cache, layer):
    if "k_scale" not in cache:
        return None
    return cache["k_scale"][layer], cache["v_scale"][layer]


@torch.no_grad()
def decode_step(
    params: Params,
    cache: Params,
    tokens: torch.Tensor,                # (B, 1) or (B, 1, K) for audio
    cfg: ModelConfig,
    eng: Optional[EnginePlan] = None,
    attn_backend: Optional[str] = None,
    active: Optional[torch.Tensor] = None,   # (B,) bool
    expert_counts: Optional[torch.Tensor] = None,   # (L, E) int32, moe
    mesh=None,
):
    """One token of autoregressive decode over the slots cache, in any of
    :func:`init_cache`'s layouts.  Returns (logits ``(B, 1, V)``, ``(B, 1,
    K, V)`` for the audio family, cache): the cache's tensors, ``pos``
    included, are updated **in place** (so a captured CUDA graph of this
    step replays against the same storage) and the returned dictionary
    holds them.  A stacked and an unstacked cache run the same layer loop
    (``cache[name][layer]`` is a view of the one, an element of the
    other), an int8 cache's scales included — the JAX package's stacked
    int8 branch, which drops them, is not followed.

    ``active``, when given, names the lanes that advance.  Every cache
    entry of the other lanes (their K/V row, conv and h states, ``pos``)
    is left bit-identical, as the JAX serving engine's ``_merge_cache``
    leaves a frozen slot, and their logits are meaningless.  The lanes
    are selected where the step writes: the K/V rows it overwrites, and
    the conv and h states, which it writes whole anyway.  The hybrid
    family's shared block attends its site's cache with the plain
    :func:`attend_decode`, as the JAX package does.

    ``mesh``: this rank's mesh.  ``params`` and ``cache`` are then the
    rank's shards (``dist.sharding.serve_param_specs`` / ``local_shard``;
    the cache at the rank's lanes and KV heads, ``init_cache(
    n_kv_heads=)``), and the step runs the paged steps' collectives: the
    row-parallel ``wo`` / ``w_down`` sums, the vocabulary's lookups and
    logits, and the MoE combine over the model group.  SSM blocks are
    whole on every rank.  The returned logits are full width over the
    rank's lanes."""
    _check_family(cfg, FAMILIES)
    plan, _ = _resolve(eng, attn_backend, tokens.device, mesh)
    view = rank_view(params, cfg, mesh)
    pos = cache["pos"]
    x = _embed(params, tokens, cfg, view)
    if "k_global" in cache:
        gi = li = 0
        for layer, lp in enumerate(params["layers"]):
            if cfg.is_global_layer(layer):
                x = _attn_decode_apply(lp, x, cache["k_global"][gi],
                                       cache["v_global"][gi], pos, cfg,
                                       plan, 0, view, active)
                gi += 1
            else:
                x = _attn_decode_apply_ring(lp, x, cache["k_local"][li],
                                            cache["v_local"][li], pos, cfg,
                                            plan, view, active)
                li += 1
            x, _ = _ffn_apply(lp, x, cfg, plan,
                              _layer_counts(expert_counts, layer), view)
    elif cfg.family in PAGED_FAMILIES:
        for layer, (lp, win) in enumerate(zip(params["layers"],
                                              _layer_windows(cfg))):
            x = _attn_decode_apply(lp, x, cache["k"][layer],
                                   cache["v"][layer], pos, cfg, plan, win,
                                   view, active, _layer_scales(cache, layer))
            x, _ = _ffn_apply(lp, x, cfg, plan,
                              _layer_counts(expert_counts, layer), view)
    else:
        shared = params.get("shared_attn")
        for layer, lp in enumerate(params["layers"]):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            conv_t, h_t = cache["conv"][layer], cache["h"][layer]
            y, conv, h_state = ssm_decode_step(lp["ssm"], h, cfg, conv_t,
                                               h_t, plan)
            x = x + y
            conv = conv.to(conv_t.dtype)
            if active is not None:
                conv = torch.where(active[:, None, None], conv, conv_t)
                h_state = torch.where(active[:, None, None, None], h_state,
                                      h_t)
            conv_t.copy_(conv)
            h_t.copy_(h_state)
            site = _site(cfg, layer)
            if shared is not None and site is not None:
                x = _attn_decode_apply(shared, x, cache["k"][site],
                                       cache["v"][site], pos, cfg, plan, 0,
                                       view, active)
                x = _mlp_apply(shared, x, cfg, plan, view)
    logits = _lm_logits(params, x, cfg, plan, view)
    pos.add_(1 if active is None else active.to(pos.dtype))
    return logits, dict(cache)


# ---------------------------------------------------------------------------
# a mesh rank's view of the model
# ---------------------------------------------------------------------------


class RankView(NamedTuple):
    """What one rank of a mesh holds, read from its shards' widths in one
    place (:func:`rank_view`): its query and KV heads, the model group
    over which each sharded block sums or gathers (None where the block
    is whole on the rank), and its slice of a MoE layer's experts."""

    hq: int
    hkv: int
    attn_group: Any       # wo row-parallel: sum its partials
    mlp_group: Any        # w_down row-parallel: sum its partials
    vocab_group: Any      # embedding rows sharded: sum the lookups
    vocab_lo: int         # first vocabulary row this rank holds
    head_group: Any       # head's logits sharded: gather them
    expert_group: Any = None    # experts sharded: sum the contributions
    expert_lo: int = 0          # first expert this rank holds
    n_experts: Optional[int] = None   # experts this rank holds (None: all)
    data_group: Any = None      # full-sequence pass: the batch's shards
    data_count: int = 1


def _width(p) -> int:
    """Output features of a dense or packed linear."""
    return as_packed(p).out_features if is_packed(p) else p["w"].shape[-1]


def _first_block(params: Params, *names: str,
                 layer0: Optional[Params] = None) -> Optional[Params]:
    """The first block found under one of ``names`` (a ``/`` path) in a
    layer (``layer0``, or the first of ``params["layers"]``), else in the
    hybrid's ``shared_attn``; None when none is."""
    first = [layer0] if layer0 is not None else list(params["layers"][:1])
    for where in first + [params.get("shared_attn")]:
        for name in names:
            node = where
            for key in name.split("/"):
                node = node.get(key) if isinstance(node, dict) else None
            if node is not None:
                return node
    return None


def rank_view(params: Params, cfg: ModelConfig, mesh,
              model_axis: str = "model",
              layer0: Optional[Params] = None) -> RankView:
    """This rank's :class:`RankView`, for every family: the heads from the
    first attention block present (a layer's, or the hybrid's
    ``shared_attn``), the MLP's cut from the first MLP (a layer's, a MoE
    layer's shared expert, the hybrid's shared one), the experts from the
    first MoE layer's stacked ``w_gate``, the vocabulary from the
    embedding's axis −2 (``(V, D)``, or the audio family's ``(K, V,
    D)``).  Every layer is cut alike, so the first speaks for all; SSM
    blocks are whole.  Without a mesh: the whole model, no group.
    ``layer0``: the layer to read in place of ``params["layers"][0]``
    (FSDP's gathered shapes, where the layers hold storage shards)."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if mesh is None:
        return RankView(hq, hkv, None, None, None, 0, None)
    group = mesh.group(model_axis)
    index = mesh.index(model_axis)
    dh = cfg.resolved_head_dim
    attn = _first_block(params, "attn", layer0=layer0)
    hq_l, hkv_l = ((_width(attn["wq"]) // dh, _width(attn["wk"]) // dh)
                   if attn is not None else (hq, hkv))
    mlp = _first_block(params, "mlp", "moe/shared", layer0=layer0)
    mlp_cut = mlp is not None and _width(mlp["w_up"]) < cfg.d_ff
    experts = _first_block(params, "moe/w_gate", layer0=layer0)
    e_local = None
    if experts is not None:
        e_local = (as_packed(experts).packed if is_packed(experts)
                   else experts).shape[0]
    expert_cut = e_local is not None and e_local < cfg.n_experts
    vocab = params["embed"].shape[-2]
    head_width = cfg.vocab_size * cfg.n_codebooks
    if cfg.tie_embeddings:
        head_sharded = vocab < cfg.vocab_size
    else:
        head_sharded = _width(params["lm_head"]) < head_width
    return RankView(
        hq_l, hkv_l,
        attn_group=group if hq_l < hq else None,
        mlp_group=group if mlp_cut else None,
        vocab_group=group if vocab < cfg.vocab_size else None,
        vocab_lo=index * vocab,
        head_group=group if head_sharded else None,
        expert_group=group if expert_cut else None,
        expert_lo=index * e_local if expert_cut else 0,
        n_experts=e_local if expert_cut else None)


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
    tokens: torch.Tensor,               # (B, 1) or (B, 1, K) for audio
    cfg: ModelConfig,
    eng: Optional[EnginePlan] = None,
    attn_backend: Optional[str] = None,
    expert_counts: Optional[torch.Tensor] = None,   # (L, E) int32, moe
    mesh=None,
) -> torch.Tensor:
    """One token of greedy decode over paged KV; returns logits
    ``(B, 1, V)`` (``(B, 1, K, V)`` for the audio family).  Inactive lanes
    write their K/V into the null page and their logits are meaningless
    (in a moe layer each lane routes its own token: a lane's capacity is
    its own).  ``pages`` is updated in place.

    ``mesh``: this rank's mesh.  ``params`` and ``pages`` are then the
    rank's shards (``dist.sharding.serve_param_specs`` /
    ``local_shard``): the heads it holds run on its KV-head slice of the
    pool, the row-parallel ``wo`` / ``w_down`` sums and the vocabulary's
    lookups and logits and a MoE layer's combine cross the model group,
    and the returned logits are full width."""
    _check_family(cfg)
    plan, abk = _resolve(eng, attn_backend, tokens.device, mesh)
    view = rank_view(params, cfg, mesh)
    b = tokens.shape[0]
    dh, hq, hkv = cfg.resolved_head_dim, view.hq, view.hkv
    x = _embed(params, tokens, cfg, view)
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
        o = sharded_paged_attention(q, kp, vp, block_tables, pos, win, ks,
                                    vs, attn_backend=abk)
        x = x + row_dense(lp["attn"]["wo"], o.reshape(b, 1, hq * dh), plan,
                           view.attn_group)
        x, _ = _ffn_apply(lp, x, cfg, plan,
                          _layer_counts(expert_counts, layer), view)
    return _lm_logits(params, x, cfg, plan, view)


@torch.no_grad()
def prefill_chunk(
    params: Params,
    pages,                              # KVPages
    block_tables: torch.Tensor,         # (B, n_blocks) int32
    tokens: torch.Tensor,               # (B, C) or (B, C, K) for audio
    pos0: torch.Tensor,                 # (B,) tokens already prefilled
    seq_lens: torch.Tensor,             # (B,) total valid after this chunk
    cfg: ModelConfig,
    eng: Optional[EnginePlan] = None,
    attn_backend: Optional[str] = None,
    expert_counts: Optional[torch.Tensor] = None,   # (L, E) int32, moe
    mesh=None,
) -> torch.Tensor:
    """One batched chunk of prompt prefill against paged KV.

    Lane ``b`` contributes tokens for positions ``[pos0[b], seq_lens[b])``;
    chunk padding and idle lanes (``seq_lens == pos0``) write into the null
    page and their queries are ignored.  Attention sees the lane's whole
    resident prefix plus this chunk.  Returns the last valid token's
    logits ``(B, 1, V)`` (``(B, 1, K, V)`` for the audio family);
    ``pages`` is updated in place.  In a moe layer
    every position of a lane's chunk routes, the padding too, and takes
    capacity from the lane's tokens, as in the JAX package.  ``mesh``: as
    in :func:`decode_step_paged`.
    """
    _check_family(cfg)
    plan, abk = _resolve(eng, attn_backend, tokens.device, mesh)
    view = rank_view(params, cfg, mesh)
    b, c = tokens.shape[:2]
    dh, hq, hkv = cfg.resolved_head_dim, view.hq, view.hkv
    pos0, seq_lens = pos0.long(), seq_lens.long()
    positions = pos0[:, None] + torch.arange(c, device=tokens.device)[None]
    valid_q = positions < seq_lens[:, None]
    x = _embed(params, tokens, cfg, view)
    pidx, poff = _scatter_targets(block_tables, positions, valid_q,
                                  pages.page_size)
    bounds = dict(positions=positions, pos0=pos0, seq_lens=seq_lens)
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
        o = sharded_paged_attention(q, kp, vp, block_tables, pos0, win, ks,
                                    vs, attn_backend=abk, prefill=bounds)
        x = x + row_dense(lp["attn"]["wo"], o.reshape(b, c, hq * dh), plan,
                           view.attn_group)
        x, _ = _ffn_apply(lp, x, cfg, plan,
                          _layer_counts(expert_counts, layer), view)
    last = torch.clamp(seq_lens - pos0 - 1, 0, c - 1)
    h_last = x[torch.arange(b, device=x.device), last][:, None]
    return _lm_logits(params, h_last, cfg, plan, view)


# ---------------------------------------------------------------------------
# engine quantization
# ---------------------------------------------------------------------------


def _partition(key: str) -> str:
    """The mesh partition preference stamped on a packed linear, from its
    name: row-parallel for the sharding rules' row set, else column."""
    return "row" if key in _ROW else "col"


def _quantize_layer(layer: Params, bits: int) -> Params:
    out: Params = {}
    for key, val in layer.items():
        if key in _QUANT_KEYS and isinstance(val, dict) and "w" in val:
            out[key] = pack_linear(val["w"], bits, bias=val.get("bias"),
                                   partition=_partition(key))
        elif key in _QUANT_KEYS and torch.is_tensor(val) and val.ndim == 3:
            out[key] = pack_linear(val, bits)             # stacked experts
        elif isinstance(val, dict):
            out[key] = _quantize_layer(val, bits)
        else:
            out[key] = val
    return out


@torch.no_grad()
def quantize_params(params: Params, cfg: ModelConfig, bits: int = 8
                    ) -> Params:
    """Every linear of the tree becomes a :class:`PackedLinear` — each
    layer's, the hybrid family's shared block's and the ``lm_head`` — a
    moe layer's stacked experts one ``(E, Kp, N)`` linear each, as the JAX
    package's walk of the whole tree packs them; embeddings, norms and the
    router stay dense.  Already-packed linears pass through.  Packing runs
    layer by layer."""
    _check_family(cfg, FAMILIES)
    out = _quantize_layer({k: v for k, v in params.items()
                           if k != "layers"}, bits)
    out["layers"] = [_quantize_layer(lp, bits) for lp in params["layers"]]
    return out
