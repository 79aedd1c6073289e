"""Analytic per-op cost models + the per-step serve-path cost ledger.

This module is the one place the port prices an engine op in FLOPs and
device-memory bytes, with the JAX package's formulas (``repro.obs.costs``)
so that both packages' ledgers agree op by op:

  * ``gemv_cost`` — a :class:`~repro_torch.engine.PackedLinear` (or dense)
    apply, per (shape, bits): 2·K·N FLOPs/token against ``bits/8``
    bytes/weight of stationary traffic — the paper's roofline argument.
  * ``decode_attn_bytes`` / ``prefill_attn_bytes`` — the gather-vs-fused
    paged-attention traffic models (``gather`` materializes the logical
    view, ``cuda`` is the in-place kernel).
  * ``decode_attn_flops`` / ``prefill_attn_flops`` — the matching compute
    models over the *padded* logical view the gather backend attends.
  * ``fork_bytes`` / ``kv_write_bytes`` — prefix-cache COW tail-page forks
    and the per-step KV scatter into the page pool.
  * ``decode_step_costs`` / ``prefill_chunk_costs`` — whole-step op→cost
    tables for the paged serve path, built from :func:`linear_specs` (the
    live parameters) or :func:`specs_from_dims` (pure dimensions).  Their
    dot FLOPs are held against ``torch.utils.flop_counter.FlopCounterMode``
    over the plain steps in ``tests/test_torch_costs.py``.
  * :class:`CostLedger` — per-op + per-request accumulation, including
    retry-wasted work from the ``repro_torch.ft`` chaos path; owned by
    ``repro_torch.obs.Telemetry`` and surfaced as
    ``ServeEngine.metrics()["costs"]``.

No serve/model imports here (obs never imports serve): parameters and
model configs are duck-typed.

The elementwise constants below (``RMSNORM_FLOPS_PER_ELEM`` …) price the
non-matmul ops at 1 FLOP per arithmetic element, transcendentals counted
into ``flops`` too, as the JAX package's HLO analyzer counts them.  They
are small corrections: at serving shapes the dots dominate.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

__all__ = [
    "OpCost",
    "LinearSpec",
    "ModelDims",
    "gemv_cost",
    "decode_attn_bytes",
    "prefill_attn_bytes",
    "decode_attn_flops",
    "prefill_attn_flops",
    "fork_bytes",
    "kv_write_bytes",
    "linear_specs",
    "specs_from_dims",
    "model_dims",
    "decode_step_costs",
    "prefill_chunk_costs",
    "CostLedger",
]


# ---------------------------------------------------------------------------
# cost record
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpCost:
    """FLOPs + device-memory bytes of one op class for one step."""

    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.flops + other.flops, self.bytes + other.bytes)

    def scaled(self, k: float) -> "OpCost":
        return OpCost(self.flops * k, self.bytes * k)


def total_cost(op_costs: Dict[str, OpCost]) -> OpCost:
    t = OpCost()
    for c in op_costs.values():
        t = t + c
    return t


# ---------------------------------------------------------------------------
# GEMV backend apply
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Shape/precision of one linear on the serve path.

    ``stack``: leading multiplicity — scanned layers or stacked experts
    (a spec with ``stack=L`` is applied once per layer per step).
    ``bits``: 0 = dense (float) weights, else the engine's packed width.
    ``weight_itemsize``: bytes/element of the *stored* dense weight
    (2 for bf16 params); ignored when ``bits`` is set.
    """

    name: str
    in_features: int
    out_features: int
    bits: int = 0
    stack: int = 1
    bias: bool = False
    partition: Optional[str] = None
    weight_itemsize: int = 2

    @property
    def key(self) -> str:
        return f"gemv/{self.name}"


def gemv_cost(
    spec: LinearSpec,
    *,
    tokens: int,
    act_itemsize: int = 4,
) -> OpCost:
    """One application of ``spec`` to ``tokens`` activation rows.

    FLOPs: the dot (2·K·N per token) + bias add + per-output-channel
    scale apply on the quantized path.  Bytes: the stationary weight read
    once (``bits/8`` bytes/weight with the engine — the paper's
    memory-capacity scaling — else the dense itemsize), scales + bias,
    and the activation stream in/out.
    """
    k, n = spec.in_features, spec.out_features
    flops = 2.0 * k * n * tokens
    if spec.bias:
        flops += n * tokens
    if spec.bits:
        flops += n * tokens                      # fold per-channel scales
        weight = k * n * (spec.bits / 8.0)
        weight += n * 4                          # f32 scales
    else:
        weight = k * n * spec.weight_itemsize
    if spec.bias:
        weight += n * spec.weight_itemsize
    acts = (k + n) * tokens * act_itemsize
    return OpCost(flops, weight + acts)


# ---------------------------------------------------------------------------
# paged attention: bytes
# ---------------------------------------------------------------------------


def decode_attn_bytes(
    backend: str,
    *,
    batch: int,
    context: int,
    n_kv_heads: int,
    head_dim: int,
    n_q_heads: int,
    page_size: int,
    kv_bits: int = 0,
    act_itemsize: int = 4,
) -> int:
    """Modeled HBM bytes moved by ONE layer's decode-attention read path.

    ``gather`` (the reference backend) materializes the logical KV view
    before attending — per K and per V it pays pool read + view write +
    view read (3× the view), and the int8 path pays the same 3× for each
    scale pool.  The in-place kernel (``cuda``) reads each mapped page
    exactly once per (lane, kv head) and never writes an intermediate: 1×
    the view (+ 1× scales), plus the block table itself.  Q read and O
    write are identical on both paths and included for honest totals.
    """
    kv_isz = 1 if kv_bits else act_itemsize
    n_blocks = max(1, math.ceil(context / page_size))
    view = batch * n_blocks * page_size * n_kv_heads * head_dim * kv_isz
    scale_view = (batch * n_blocks * page_size * n_kv_heads * 2
                  if kv_bits else 0)  # bf16 scales
    qo = 2 * batch * n_q_heads * head_dim * act_itemsize  # Q read + O write
    tables = batch * n_blocks * 4                         # int32 block table
    if backend == "gather":
        return 2 * 3 * view + 2 * 3 * scale_view + qo + tables
    if backend == "cuda":
        return 2 * view + 2 * scale_view + qo + tables
    raise ValueError(f"unknown attention backend {backend!r}")


def prefill_attn_bytes(
    backend: str,
    *,
    batch: int,
    chunk: int,
    context: int,
    n_kv_heads: int,
    head_dim: int,
    n_q_heads: int,
    page_size: int,
    kv_bits: int = 0,
    act_itemsize: int = 4,
) -> int:
    """Modeled HBM bytes moved by ONE layer's chunked-prefill read path.

    Same accounting as :func:`decode_attn_bytes` with a ``chunk``-token
    query block instead of one token: ``gather`` materializes the full
    logical view (pool read + view write + view read, 3× per K/V and per
    scale pool) before ``attend_dense`` reads it; the in-place prefill
    kernel streams each mapped page once per (lane, kv head), 1× the view.  The
    chunk's own K/V scatter into the pool is identical on both paths and
    excluded.  Q read and O write cover the whole chunk.
    """
    kv_isz = 1 if kv_bits else act_itemsize
    n_blocks = max(1, math.ceil(context / page_size))
    view = batch * n_blocks * page_size * n_kv_heads * head_dim * kv_isz
    scale_view = (batch * n_blocks * page_size * n_kv_heads * 2
                  if kv_bits else 0)
    qo = 2 * batch * chunk * n_q_heads * head_dim * act_itemsize
    tables = batch * n_blocks * 4
    if backend == "gather":
        return 2 * 3 * view + 2 * 3 * scale_view + qo + tables
    if backend == "cuda":
        return 2 * view + 2 * scale_view + qo + tables
    raise ValueError(f"unknown attention backend {backend!r}")


# ---------------------------------------------------------------------------
# paged attention: FLOPs
# ---------------------------------------------------------------------------

# elementwise pricing constants, at 1 FLOP per element (transcendentals
# count into flops):
#   softmax over S scores/row: max-reduce + subtract + exp + sum-reduce +
#   divide, plus the causal/window compare + select over the score grid.
SOFTMAX_FLOPS_PER_SCORE = 7.0
#   rms_norm over d elems: square + mean-reduce + rsqrt + 3 muls/adds.
RMSNORM_FLOPS_PER_ELEM = 6.0
#   rope on (H, Dh): angle mul + sin + cos on Dh/2, then 6 mul/adds on
#   each rotated half -> ~4.5 per (head, dim) element.
ROPE_FLOPS_PER_ELEM = 4.5
#   silu(gate)*up (logistic counts 1) or gelu: ~4 per hidden element.
ACT_FLOPS_PER_ELEM = 4.0
#   int8 KV quantize: abs + max-reduce + divide + clamp + round per elem.
QUANT_FLOPS_PER_ELEM = 6.0


def decode_attn_flops(
    *,
    batch: int,
    context: int,
    n_q_heads: int,
    head_dim: int,
    kv_bits: int = 0,
) -> float:
    """ONE layer's decode-attention FLOPs over the padded logical view.

    Both backends compute the same math: q·K over every (padded) logical
    position (masking, not slicing, hides unwritten slots), softmax, p·V.
    ``context`` must be the PADDED view length — ``n_blocks * page_size``
    — which is what the engine actually attends.
    """
    qk_pv = 4.0 * batch * context * n_q_heads * head_dim
    soft = SOFTMAX_FLOPS_PER_SCORE * batch * n_q_heads * context
    if kv_bits:
        soft += 2.0 * batch * n_q_heads * context  # fold k/v scales into p
    return qk_pv + soft


def prefill_attn_flops(
    *,
    batch: int,
    chunk: int,
    context: int,
    n_q_heads: int,
    head_dim: int,
    kv_bits: int = 0,
) -> float:
    """ONE layer's chunked-prefill attention FLOPs (``chunk`` query rows
    against the padded ``context``-long logical view)."""
    qk_pv = 4.0 * batch * chunk * context * n_q_heads * head_dim
    soft = SOFTMAX_FLOPS_PER_SCORE * batch * n_q_heads * chunk * context
    if kv_bits:
        soft += 2.0 * batch * n_q_heads * chunk * context
    return qk_pv + soft


# ---------------------------------------------------------------------------
# page-pool traffic: KV scatter + COW forks
# ---------------------------------------------------------------------------


def kv_write_bytes(
    *,
    tokens: int,
    n_layers: int,
    n_kv_heads: int,
    head_dim: int,
    kv_bits: int = 0,
    act_itemsize: int = 4,
) -> float:
    """Scatter of ``tokens`` new K/V entries into the page pool, all
    layers.  The pool is written in place, so traffic is the touched
    region read+write (2×), per K and per V, plus int8 scale entries."""
    kv_isz = 1 if kv_bits else act_itemsize
    per_tok = 2 * n_kv_heads * head_dim * kv_isz          # K + V entries
    if kv_bits:
        per_tok += 2 * n_kv_heads * 2                     # bf16 scales
    return 2.0 * tokens * n_layers * per_tok


def kv_write_flops(
    *,
    tokens: int,
    n_layers: int,
    n_kv_heads: int,
    head_dim: int,
    kv_bits: int = 0,
) -> float:
    """Scatter combine fn (1/elem) + int8 quantize."""
    elems = tokens * n_layers * 2 * n_kv_heads * head_dim
    flops = float(elems)
    if kv_bits:
        flops += QUANT_FLOPS_PER_ELEM * elems
    return flops


def fork_bytes(
    *,
    n_layers: int,
    page_size: int,
    n_kv_heads: int,
    head_dim: int,
    kv_bits: int = 0,
    act_itemsize: int = 4,
) -> float:
    """One prefix-cache copy-on-write tail-page fork: read + write of a
    whole K page and V page across every layer (plus int8 scale pages) —
    exactly what ``PageAllocator.fork_tail_page`` copies."""
    kv_isz = 1 if kv_bits else act_itemsize
    page = page_size * n_kv_heads * head_dim * kv_isz
    per_layer = 2 * 2 * page                              # rd+wr, K and V
    if kv_bits:
        per_layer += 2 * 2 * page_size * n_kv_heads * 2   # scale pages
    return float(n_layers * per_layer)


# ---------------------------------------------------------------------------
# linear specs: from live parameters or from pure dimensions
# ---------------------------------------------------------------------------


# the row-parallel linears (they consume head- or hidden-sharded
# activations); every other packed linear is column-parallel.  The JAX
# package records this preference on its PackedLinear at pack time.
_ROW_PARALLEL = {"wo", "w_down", "out_proj"}


def _is_packed(p: Any) -> bool:
    return (hasattr(p, "packed") and hasattr(p, "bits")
            and hasattr(p, "in_features"))


def _fold(specs: List[LinearSpec]) -> List[LinearSpec]:
    """Specs of the same name (one per element of a layer list) as one
    spec whose ``stack`` is their sum; their shapes must agree."""
    out: "OrderedDict[str, LinearSpec]" = OrderedDict()
    for s in specs:
        have = out.get(s.name)
        if have is None:
            out[s.name] = s
            continue
        if dataclasses.replace(have, stack=s.stack) != s:
            raise ValueError(f"linear {s.name!r} differs across the "
                             f"list: {have} vs {s}")
        out[s.name] = dataclasses.replace(have, stack=have.stack + s.stack)
    return list(out.values())


def linear_specs(params: Any, prefix: str = "") -> List[LinearSpec]:
    """Walk a (possibly engine-quantized) parameter tree into LinearSpecs.

    Duck-typed: ``PackedLinear`` leaves carry their own bits/shape (a
    stacked ``(E, Kp, N)`` expert linear is ``stack`` = E, as in JAX);
    ``{"w"[, "bias"]}`` dicts are dense linears.  A list (the port's
    per-layer list, ``params["layers"]``) folds the same linear of every
    element into one spec with ``stack`` = the list's length — the spec
    the JAX package reads off the stacked leading axis of its scanned
    layers — so the op keys (``gemv/layers/attn/wq`` …) are the JAX
    package's.  Norm scales, embeddings and other raw tensors are not
    linears and are skipped (they are priced in the "other" bucket of the
    step models).
    """
    out: List[LinearSpec] = []
    if _is_packed(params):
        key = prefix.rsplit("/", 1)[-1]
        lead = tuple(params.packed.shape[:-2])
        stack = 1
        for d in lead:
            stack *= int(d)
        out.append(LinearSpec(
            name=prefix or "linear",
            in_features=int(params.in_features),
            out_features=int(params.out_features),
            bits=int(params.bits),
            stack=stack,
            bias=getattr(params, "bias", None) is not None,
            # stacked experts: JAX packs them with no partition preference
            partition=(None if lead else
                       "row" if key in _ROW_PARALLEL else "col"),
        ))
        return out
    if isinstance(params, (list, tuple)):
        for sub in params:
            out.extend(linear_specs(sub, prefix))
        return _fold(out)
    if isinstance(params, dict):
        w = params.get("w")
        if w is not None and getattr(w, "ndim", 0) >= 2 \
                and not isinstance(w, dict):
            stack = 1
            for d in w.shape[:-2]:
                stack *= int(d)
            out.append(LinearSpec(
                name=prefix or "linear",
                in_features=int(w.shape[-2]),
                out_features=int(w.shape[-1]),
                bits=0,
                stack=stack,
                bias="bias" in params,
                weight_itemsize=int(w.element_size()),
            ))
            return out
        for key in sorted(params):
            sub = params[key]
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(sub, (dict, list, tuple)) or _is_packed(sub):
                out.extend(linear_specs(sub, name))
    return out


# the stacked expert linears of a moe layer, by the end of their spec names
EXPERT_LINEARS = ("moe/w_gate", "moe/w_up", "moe/w_down")


def routed_costs(table: Dict[str, OpCost], specs: Sequence[LinearSpec], *,
                 touched: float) -> Dict[str, OpCost]:
    """A step's op table with its stacked expert linears priced for the
    experts the step's routing sent rows to: ``touched`` expert-layers
    (distinct experts a layer, summed over layers) in place of every
    expert of every layer.  The ledger (``table``), as the JAX package's,
    prices them all; a grouped launch reads only the touched experts'
    codes, so a bytes share of the card is stated on this table."""
    out = dict(table)
    for s in specs:
        if s.name.endswith(EXPERT_LINEARS) and s.key in table:
            out[s.key] = table[s.key].scaled(touched / s.stack)
    return out


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """The dimensions the step cost models need, decoupled from
    ``ModelConfig`` (tests can synthesize them directly)."""

    n_layers: int
    d_model: int
    n_q_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    mlp_gated: bool = True
    qkv_bias: bool = False
    tie_embeddings: bool = False


def model_dims(cfg: Any) -> ModelDims:
    """Extract :class:`ModelDims` from a ``ModelConfig`` (duck-typed)."""
    return ModelDims(
        n_layers=int(cfg.n_layers),
        d_model=int(cfg.d_model),
        n_q_heads=int(cfg.n_heads),
        n_kv_heads=int(cfg.n_kv_heads),
        head_dim=int(cfg.resolved_head_dim),
        d_ff=int(cfg.d_ff),
        vocab_size=int(cfg.vocab_size),
        mlp_gated=bool(cfg.mlp_gated),
        qkv_bias=bool(cfg.qkv_bias),
        tie_embeddings=bool(cfg.tie_embeddings),
    )


def specs_from_dims(
    dims: ModelDims,
    weight_bits: int = 0,
    *,
    weight_itemsize: int = 2,
) -> List[LinearSpec]:
    """Synthesize the dense-family per-layer linears + LM head from pure
    dimensions — the same shapes ``linear_specs`` recovers from a live
    param tree, so tests and the engine price GEMVs through one path."""
    d, dh = dims.d_model, dims.head_dim
    hq, hkv, l = dims.n_q_heads, dims.n_kv_heads, dims.n_layers

    def spec(name, k, n, stack=l, bias=False, part=None):
        return LinearSpec(name=name, in_features=k, out_features=n,
                          bits=weight_bits, stack=stack, bias=bias,
                          partition=part,
                          weight_itemsize=weight_itemsize)

    out = [
        spec("layers/attn/wq", d, hq * dh, bias=dims.qkv_bias, part="col"),
        spec("layers/attn/wk", d, hkv * dh, bias=dims.qkv_bias, part="col"),
        spec("layers/attn/wv", d, hkv * dh, bias=dims.qkv_bias, part="col"),
        spec("layers/attn/wo", hq * dh, d, part="row"),
        spec("layers/mlp/w_up", d, dims.d_ff, part="col"),
        spec("layers/mlp/w_down", dims.d_ff, d, part="row"),
    ]
    if dims.mlp_gated:
        out.insert(4, spec("layers/mlp/w_gate", d, dims.d_ff, part="col"))
    # tied embeddings still pay the full logits dot; bits never applies to
    # the tied embedding table (quantize_params packs lm_head only).
    out.append(spec("lm_head", d, dims.vocab_size, stack=1,
                    bias=False, part="col")
               if not dims.tie_embeddings else
               LinearSpec(name="lm_head", in_features=d,
                          out_features=dims.vocab_size, bits=0, stack=1,
                          weight_itemsize=weight_itemsize))
    return out


# ---------------------------------------------------------------------------
# whole-step models
# ---------------------------------------------------------------------------


def _with_lm_head(dims: ModelDims, specs, weight_bits: int):
    """Specs for one step, guaranteed to include the logits dot.

    ``linear_specs`` of a tied-embedding param tree finds no ``lm_head``
    leaf (the embedding table is a raw array), but the model still pays
    the full ``d × vocab`` einsum per logit token — synthesize that spec
    from dims so the engine's live-tree tables price it too.
    """
    if specs is None:
        return specs_from_dims(dims, weight_bits)
    specs = list(specs)
    if not any(s.name.endswith("lm_head") for s in specs):
        specs.append(LinearSpec(
            name="lm_head", in_features=dims.d_model,
            out_features=dims.vocab_size, bits=0, stack=1))
    return specs


def _other_decode(dims: ModelDims, tokens: int, logit_tokens: int,
                  act_itemsize: int) -> OpCost:
    """Everything that is neither a GEMV, paged attention, nor the KV
    scatter: embed gather, norms, RoPE, residual adds, MLP activation,
    final norm.  Priced at 1 FLOP per element."""
    d, dh = dims.d_model, dims.head_dim
    hq, hkv, l = dims.n_q_heads, dims.n_kv_heads, dims.n_layers
    per_tok = 0.0
    per_tok += l * 2 * RMSNORM_FLOPS_PER_ELEM * d            # ln1 + ln2
    per_tok += l * ROPE_FLOPS_PER_ELEM * (hq + hkv) * dh     # rope q, k
    per_tok += l * 2 * d                                     # residuals
    # gated: silu(gate) * up (logistic + 2 muls); plain: tanh-approx gelu.
    act_per_elem = 3.0 if dims.mlp_gated else ACT_FLOPS_PER_ELEM
    per_tok += l * act_per_elem * dims.d_ff
    flops = per_tok * tokens
    flops += RMSNORM_FLOPS_PER_ELEM * d * logit_tokens       # final norm
    nbytes = 2.0 * tokens * d * act_itemsize                 # embed gather
    nbytes += 2.0 * l * 4 * tokens * d * act_itemsize        # norm/res/act
    return OpCost(flops, nbytes)


def decode_step_costs(
    dims: ModelDims,
    *,
    batch: int,
    context: int,
    page_size: int,
    attn_backend: str = "gather",
    weight_bits: int = 0,
    kv_bits: int = 0,
    act_itemsize: int = 4,
    specs: Optional[Sequence[LinearSpec]] = None,
) -> Dict[str, OpCost]:
    """Op → cost table for ONE paged decode step over ``batch`` lanes.

    ``context`` is the PADDED logical view length each lane attends —
    ``max_blocks * page_size`` in the engine.  ``specs`` defaults to
    :func:`specs_from_dims`; pass :func:`linear_specs` of the live param
    tree to price the actual (possibly packed) weights.
    """
    specs = _with_lm_head(dims, specs, weight_bits)
    padded = max(1, math.ceil(context / page_size)) * page_size
    out: Dict[str, OpCost] = {}
    for s in specs:
        c = gemv_cost(s, tokens=batch, act_itemsize=act_itemsize)
        out[s.key] = out.get(s.key, OpCost()) + c.scaled(s.stack)
    out["attn_decode"] = OpCost(
        dims.n_layers * decode_attn_flops(
            batch=batch, context=padded, n_q_heads=dims.n_q_heads,
            head_dim=dims.head_dim, kv_bits=kv_bits),
        dims.n_layers * decode_attn_bytes(
            attn_backend, batch=batch, context=padded,
            n_kv_heads=dims.n_kv_heads, head_dim=dims.head_dim,
            n_q_heads=dims.n_q_heads, page_size=page_size,
            kv_bits=kv_bits, act_itemsize=act_itemsize),
    )
    out["kv_write"] = OpCost(
        kv_write_flops(tokens=batch, n_layers=dims.n_layers,
                       n_kv_heads=dims.n_kv_heads, head_dim=dims.head_dim,
                       kv_bits=kv_bits),
        kv_write_bytes(tokens=batch, n_layers=dims.n_layers,
                       n_kv_heads=dims.n_kv_heads, head_dim=dims.head_dim,
                       kv_bits=kv_bits, act_itemsize=act_itemsize),
    )
    out["other"] = _other_decode(dims, batch, batch, act_itemsize)
    return out


def prefill_chunk_costs(
    dims: ModelDims,
    *,
    batch: int,
    chunk: int,
    context: int,
    page_size: int,
    attn_backend: str = "gather",
    weight_bits: int = 0,
    kv_bits: int = 0,
    act_itemsize: int = 4,
    specs: Optional[Sequence[LinearSpec]] = None,
) -> Dict[str, OpCost]:
    """Op → cost table for ONE chunked-prefill step (``chunk`` tokens per
    lane).  The LM head runs on the last token only (``prefill_chunk``
    computes logits for one position per lane)."""
    specs = _with_lm_head(dims, specs, weight_bits)
    padded = max(1, math.ceil(context / page_size)) * page_size
    tokens = batch * chunk
    out: Dict[str, OpCost] = {}
    for s in specs:
        t = batch if s.name.endswith("lm_head") else tokens
        c = gemv_cost(s, tokens=t, act_itemsize=act_itemsize)
        out[s.key] = out.get(s.key, OpCost()) + c.scaled(s.stack)
    out["attn_prefill"] = OpCost(
        dims.n_layers * prefill_attn_flops(
            batch=batch, chunk=chunk, context=padded,
            n_q_heads=dims.n_q_heads, head_dim=dims.head_dim,
            kv_bits=kv_bits),
        dims.n_layers * prefill_attn_bytes(
            attn_backend, batch=batch, chunk=chunk, context=padded,
            n_kv_heads=dims.n_kv_heads, head_dim=dims.head_dim,
            n_q_heads=dims.n_q_heads, page_size=page_size,
            kv_bits=kv_bits, act_itemsize=act_itemsize),
    )
    out["kv_write"] = OpCost(
        kv_write_flops(tokens=tokens, n_layers=dims.n_layers,
                       n_kv_heads=dims.n_kv_heads, head_dim=dims.head_dim,
                       kv_bits=kv_bits),
        kv_write_bytes(tokens=tokens, n_layers=dims.n_layers,
                       n_kv_heads=dims.n_kv_heads, head_dim=dims.head_dim,
                       kv_bits=kv_bits, act_itemsize=act_itemsize),
    )
    out["other"] = _other_decode(dims, tokens, batch, act_itemsize)
    return out


def fork_cost(
    dims: ModelDims,
    *,
    page_size: int,
    kv_bits: int = 0,
    act_itemsize: int = 4,
) -> Dict[str, OpCost]:
    """Op table for one prefix-cache COW tail-page fork (pure copies)."""
    return {"cow_fork": OpCost(0.0, fork_bytes(
        n_layers=dims.n_layers, page_size=page_size,
        n_kv_heads=dims.n_kv_heads, head_dim=dims.head_dim,
        kv_bits=kv_bits, act_itemsize=act_itemsize))}


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

Rid = Union[int, str]


class CostLedger:
    """Per-op + per-request FLOPs/bytes accumulation for one engine.

    ``charge(op_costs, rids)`` adds a step's op table to the per-op
    totals and attributes the step total evenly across the charged
    requests.  ``mark_retry(rid)`` snapshots everything charged to a
    request so far as *wasted* — a retried request replays its prompt and
    emitted tokens from scratch, so all prior work is re-done
    (``wasted_*`` monotonically tracks the last restart point).  Request
    rows are bounded FIFO; evicted rows stay in the op totals.
    """

    def __init__(self, max_requests: int = 4096):
        self.max_requests = int(max_requests)
        self.by_op: Dict[str, List[float]] = {}
        self.by_request: "OrderedDict[Rid, Dict[str, float]]" = OrderedDict()
        self.evicted_requests = 0

    # ------------------------------------------------------------------
    def _row(self, rid: Rid) -> Dict[str, float]:
        row = self.by_request.get(rid)
        if row is None:
            row = {"flops": 0.0, "bytes": 0.0,
                   "wasted_flops": 0.0, "wasted_bytes": 0.0,
                   "retries": 0}
            self.by_request[rid] = row
            while len(self.by_request) > self.max_requests:
                self.by_request.popitem(last=False)
                self.evicted_requests += 1
        return row

    def charge(
        self,
        op_costs: Dict[str, OpCost],
        rids: Iterable[Rid] = (),
    ) -> None:
        tot_f = tot_b = 0.0
        for op, c in op_costs.items():
            cur = self.by_op.setdefault(op, [0.0, 0.0])
            cur[0] += c.flops
            cur[1] += c.bytes
            tot_f += c.flops
            tot_b += c.bytes
        rids = list(rids)
        if rids:
            share_f = tot_f / len(rids)
            share_b = tot_b / len(rids)
            for rid in rids:
                row = self._row(rid)
                row["flops"] += share_f
                row["bytes"] += share_b

    def mark_retry(self, rid: Rid) -> None:
        row = self._row(rid)
        row["wasted_flops"] = row["flops"]
        row["wasted_bytes"] = row["bytes"]
        row["retries"] += 1

    # ------------------------------------------------------------------
    @property
    def total_flops(self) -> float:
        return sum(v[0] for v in self.by_op.values())

    @property
    def total_bytes(self) -> float:
        return sum(v[1] for v in self.by_op.values())

    def request(self, rid: Rid) -> Optional[Dict[str, float]]:
        row = self.by_request.get(rid)
        return dict(row) if row is not None else None

    def snapshot(self) -> Dict[str, Any]:
        return {
            "total_flops": self.total_flops,
            "total_bytes": self.total_bytes,
            "wasted_flops": sum(r["wasted_flops"]
                                for r in self.by_request.values()),
            "wasted_bytes": sum(r["wasted_bytes"]
                                for r in self.by_request.values()),
            "by_op": {op: {"flops": v[0], "bytes": v[1]}
                      for op, v in sorted(self.by_op.items())},
            "requests": {str(rid): dict(row)
                         for rid, row in self.by_request.items()},
            "evicted_requests": self.evicted_requests,
        }
