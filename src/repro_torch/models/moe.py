"""Mixture-of-Experts block: token-choice top-k routing with a per-row
(group-wise) capacity, as the JAX package's ``repro.models.moe``.

Routing is the JAX package's to the pair: float32 router logits from the
dense router, softmax, top-k (the lower expert first on a tie, as
``jax.lax.top_k``), gates renormalised over the k; each batch row routes
its own tokens, and a pair (token, slot) is kept while its rank among the
row's pairs of the same expert, counted in (token, slot) order, is below
the capacity ``max(8, ceil(S·k/E · capacity_factor))`` rounded up to 8 —
the pairs JAX's stable sort keeps.  The Switch auxiliary loss is taken
over every token, and the shared expert, if any, is added after the
routed ones.

The compute layout is the port's own.  JAX scatters each row's kept pairs
into an ``(E, C, D)`` buffer and multiplies every slot of it; here the
kept pairs of all rows are sorted by expert (stable, so by row and rank
within an expert) into one ``(P, D)`` block of rows with ``offsets
(E + 1,)`` on the device, and each expert linear runs once over it as a
grouped GEMV (``EnginePlan.apply_grouped``: on the card the bit-plane
GEMV's expert-grouped launch, which reads only the codes of the experts
that received rows).  A dropped pair is never computed and contributes
zero, as JAX's overflow row does.  The combine gathers each token's k
contributions and adds them in slot order in float32: the same order on
every run, in a captured graph as eagerly.

Nothing here reads device data on the host, so the serving steps capture
it in their CUDA graphs.

**Expert-parallel on a mesh** (``view``, a rank's ``RankView`` whose
experts are a contiguous slice ``[lo, lo + E_local)``): routing runs
whole on every rank (x and the router are replicated over the model axis,
so gates, choices and the kept mask agree everywhere); each rank sorts
and computes only the kept pairs of its own experts, the others sorting
last, and builds the ``(B, S, k, D)`` float32 contributions with zeros
in the other ranks' pairs.  The model group sums them exactly (each
element is non-zero on one rank at most), and the k slots are then added
in slot order as on one device, so the combine matches one device bit
for bit whenever the expert outputs do.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.dist.collectives import copy_to, sum_over
from repro_torch.engine import (
    EnginePlan,
    PackedLinear,
    as_packed,
    is_packed,
    pack_linear,
    plan_for_bits,
)
from repro_torch.kernels._gemv import (
    expert_slots,
    gather_slots,
    scatter_slots,
)
from repro_torch.models.layers import dense, init_linear, row_dense, swiglu


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype,
             engine_bits: int = 0) -> dict:
    """One layer's MoE parameters: the dense ``router`` ``(D, E)``,
    stacked experts ``w_gate`` / ``w_up`` ``(E, D, F)`` and ``w_down``
    ``(E, F, D)`` drawn ``N(0, 1/D)`` (the JAX package's ``init_moe``), and
    the ``shared`` expert's SwiGLU when the config has one.

    ``engine_bits`` packs each expert as soon as it is drawn, so one
    layer's experts never exist at full precision all at once."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    std = 1.0 / math.sqrt(d)

    def stacked(k, n):
        mats = []
        for _ in range(e):
            w = (torch.randn((k, n), generator=gen, device=gen.device,
                             dtype=torch.float32) * std).to(dtype)
            mats.append(pack_linear(w, engine_bits) if engine_bits else w)
        return _stack_packed(mats) if engine_bits else torch.stack(mats)

    params = {"router": init_linear(gen, d, e, dtype),
              "w_gate": stacked(d, f),
              "w_up": stacked(d, f),
              "w_down": stacked(f, d)}
    if cfg.n_shared_experts:
        fs = cfg.d_ff
        params["shared"] = {"w_gate": init_linear(gen, d, fs, dtype),
                            "w_up": init_linear(gen, d, fs, dtype),
                            "w_down": init_linear(gen, fs, d, dtype)}
    return params


def _stack_packed(lins) -> PackedLinear:
    """Per-expert ``PackedLinear`` s as one stacked ``(E, Kp, N)`` linear
    (the bytes :func:`pack_linear` gives the stacked weight)."""
    first = lins[0]
    return PackedLinear(torch.stack([p.packed for p in lins]),
                        torch.stack([p.scale for p in lins]), None,
                        first.bits, first.in_features, first.out_features)


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(-(-n_tokens * cfg.top_k * cfg.capacity_factor // cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def max_expert_rows(batch: int, seq: int, cfg: ModelConfig) -> int:
    """The most rows one expert can receive from a ``(batch, seq)`` block:
    a token's k experts are distinct, so a row gives an expert at most
    ``min(capacity, seq)`` pairs.  Fixed by the shapes, never by the data,
    so a launch sized by it can be captured in a graph."""
    return batch * min(_capacity(seq, cfg), seq)


def grouped_dense(p, x: torch.Tensor, offsets: torch.Tensor, max_rows: int,
                  plan: Optional[EnginePlan] = None) -> torch.Tensor:
    """``y[offsets[e]:offsets[e+1]] = x[...] @ W[e]`` for a stacked expert
    weight: engine-packed through ``EnginePlan.apply_grouped``, float
    ``(E, K, N)`` through :func:`grouped_matmul` in x's dtype (the JAX
    package's ``jnp.matmul(h, p.astype(h.dtype))``).  Rows past
    ``offsets[E]`` are left undefined."""
    if is_packed(p):
        lin = as_packed(p, bits_hint=plan.bits if plan else None)
        if plan is None:
            plan = plan_for_bits(lin.bits, device=x.device)
        return plan.apply_grouped(lin, x, offsets, max_rows)
    return grouped_matmul(p, x, offsets, max_rows)


def grouped_matmul(w: torch.Tensor, x: torch.Tensor, offsets: torch.Tensor,
                   max_rows: int) -> torch.Tensor:
    """The plain grouped product on float experts ``w (E, K, N)``: each
    expert's rows gathered into ``max_rows`` slots, one batched product,
    and back; no host read, so it runs inside a captured graph."""
    idx, valid = expert_slots(offsets, max_rows)
    return scatter_slots(torch.bmm(gather_slots(x, idx, valid),
                                   w.to(x.dtype)), idx, valid, x.shape[0])


def route(params, x: torch.Tensor, cfg: ModelConfig, data_group=None,
          data_count: int = 1):
    """The JAX package's routing of ``x (B, S, D)``: returns the gates
    ``(B, S, k)`` (float32, renormalised), the experts ``(B, S, k)``,
    the kept mask ``(B, S, k)`` under the per-row capacity, and the aux
    loss.  ``data_group``: the ``data_count`` data shards of a mesh whose
    rows make up the batch; the aux loss's token fractions and mean
    probabilities are then means over all of them, so every shard holds
    the whole batch's aux (under autograd each shard's probabilities take
    ``1 / data_count`` of its gradient, the share of a loss whose
    gradients are summed over the data shards)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(s, cfg)
    logits = dense(params["router"], x).to(torch.float32)      # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: on a tie the lower expert comes first, as
    # jax.lax.top_k has it
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    experts = torch.arange(e, device=x.device)
    frac_tokens = (top_i[..., 0, None] == experts).to(torch.float32).mean(
        (0, 1))
    mean_probs = probs.mean((0, 1))
    if data_group is not None:
        frac_tokens = sum_over(frac_tokens, data_group) / data_count
        mean_probs = sum_over(mean_probs, data_group) / data_count
    aux = e * torch.sum(frac_tokens * mean_probs) * cfg.router_aux_coef

    # rank of each pair among the row's pairs of its expert, in (token,
    # slot) order: the position JAX's stable sort by expert gives it
    flat_e = top_i.reshape(b, s * k)
    onehot = (flat_e[..., None] == experts).to(torch.int32)    # (B, Sk, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    rank = torch.gather(before, 2, flat_e[..., None])[..., 0]
    keep = (rank < c).reshape(b, s, k)
    return top_p, top_i, keep, aux


def moe_block(
    params,
    x: torch.Tensor,                  # (B, S, D) — or (T, D), treated as B=1
    cfg: ModelConfig,
    plan: Optional[EnginePlan] = None,
    counts: Optional[torch.Tensor] = None,
    view=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y, aux_loss)``, y of x's shape and dtype.

    ``counts``, when given, an ``(E,)`` int32 tensor, receives the rows
    each expert computed (in place, so a captured graph's replays refill
    it): a step's touched experts are read from it afterwards.  ``view``:
    a mesh rank's ``RankView``; with its experts sharded the rank computes
    its own (``counts`` gets their rows, zeros elsewhere) and the model
    group sums the contributions (module docstring); the shared expert's
    ``w_down`` sums over ``view.mlp_group``.  Under autograd the experts'
    input and the gates pass through ``copy_to`` (their gradients, partial
    on each rank, summed over the group), and the aux loss is the whole
    batch's over ``view.data_group`` (:func:`route`)."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    data = (() if view is None or view.data_group is None
            else (view.data_group, view.data_count))
    gates, experts, keep, aux = route(params, x, cfg, *data)
    lo, e_local = 0, e
    x_experts = x
    if view is not None and view.expert_group is not None:
        lo, e_local = view.expert_lo, view.n_experts
        x_experts = copy_to(x, view.expert_group)
        gates = copy_to(gates, view.expert_group)
        experts = experts - lo
        keep = keep & (experts >= 0) & (experts < e_local)

    # every kept pair of every row, sorted by expert (stable: by row, then
    # rank); dropped pairs (and another rank's) sort last under the key
    # E_local and are never computed
    n_pairs = b * s * k
    key = torch.where(keep, experts, torch.full_like(experts, e_local)
                      ).reshape(-1)
    order = torch.argsort(key, stable=True)
    offsets = torch.searchsorted(
        key[order], torch.arange(e_local + 1, device=x.device,
                                 dtype=key.dtype)
    ).to(torch.int32)
    if counts is not None:
        if e_local < e:
            counts.zero_()
        counts[lo:lo + e_local].copy_(offsets[1:] - offsets[:-1])
    xs = x_experts.reshape(b * s, d)[order // k]               # (P, D)
    max_rows = max_expert_rows(b, s, cfg)
    gate = grouped_dense(params["w_gate"], xs, offsets, max_rows, plan)
    up = grouped_dense(params["w_up"], xs, offsets, max_rows, plan)
    out = grouped_dense(params["w_down"], F.silu(gate) * up, offsets,
                        max_rows, plan)                       # (P, D)

    # combine: pair p sits at row where[p] of ``out``; each token's k
    # contributions in slot order, float32
    where = torch.empty_like(order)
    where.scatter_(0, order, torch.arange(n_pairs, device=x.device))
    contrib = out[where].reshape(b, s, k, d).to(torch.float32)
    g = gates.to(x.dtype).to(torch.float32)[..., None]
    contrib = torch.where(keep[..., None], contrib * g,
                          torch.zeros((), device=x.device))
    if e_local < e:
        contrib = sum_over(contrib, view.expert_group)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    y = y.to(x.dtype)

    if "shared" in params:
        group = view.mlp_group if view else None
        down = functools.partial(row_dense, plan=plan, group=group)
        y = y + swiglu(params["shared"], copy_to(x, group), plan, down)
    if squeeze:
        y = y[0]
    return y, aux
