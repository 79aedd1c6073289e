"""``sharded`` — the mesh's engine backend, and paged attention on a
rank's heads.

IMAGine's scaling claim is that GEMV throughput tracks the number of
memory banks holding weight bit-planes.  This backend is that claim over a
mesh of ranks: each rank owns a contiguous slice of every bit-packed
weight and runs the wrapped single-device backend (``plan.inner_backend``)
on its slice only.

The JAX package ``shard_map``s a whole weight over the mesh.  Here a rank
holds only its slice (``dist.sharding.local_shard``), which records how it
was cut in ``PackedLinear.shard``:

* **col** (an N/m slice of codes, scales and bias): x is replicated, the
  rank computes its slice of the output features, and no collective runs.
* **row** (K/m packed rows; whole scales and bias): x is the rank's K/m
  slice of the features, the partial GEMV comes out in float32 and is
  summed over the model axis by :func:`repro_torch.dist.collectives.
  psum_partial` (exact, or ``compressed_psum_leaf`` codes when
  ``plan.psum_bits`` is 4/8), then cast; the plan adds the bias after.
* a whole weight (``shard`` None), or a plan with no mesh, runs the
  wrapped backend as it is: replication, never an error.

With ``psum_bits == 0`` both cuts give the wrapped backend's output bit
for bit whenever the float32 partials are exact (integer activation and
weight grids: ``tests/test_torch_shard_engine.py`` holds this on 8
``gloo`` ranks).

* **expert** (a stacked ``(E, Kp, N)`` linear's contiguous slice of
  ``E/m`` experts): the grouped twin runs the wrapped grouped backend on
  the rank's experts only, over rows the MoE block sorted for them, and
  no collective runs here: ``models/moe.py`` sums each token's routed
  contributions over the model axis, exactly, after its combine.

Lanes over the data axes are the serving engine's business: a data
shard's rank runs only its own lanes (:func:`lane_partition`), so the
activations a backend sees are already the rank's rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dist.collectives import psum_partial
from repro_torch.dist.sharding import paged_attn_partition
from repro_torch.engine.backends import (
    get_backend,
    get_grouped_backend,
    register_backend,
    register_grouped_backend,
)
from repro_torch.engine.packed import PackedLinear


@register_backend("sharded")
def _sharded(plan, lin: PackedLinear, x: torch.Tensor, out_dtype):
    inner = get_backend(plan.inner_backend or "reference")
    if plan.mesh is None or lin.shard is None or lin.shard == "col":
        return inner(plan, lin, x, out_dtype)
    if lin.shard != "row":
        raise ValueError(f"unknown shard kind {lin.shard!r}")
    if x.shape[-1] != lin.in_features:
        raise ValueError(
            f"row-parallel shard takes this rank's {lin.in_features} input "
            f"features, got x of {x.shape[-1]}")
    part = inner(plan, lin, x, torch.float32)
    return psum_partial(part, plan.mesh.group(plan.model_axis),
                        bits=plan.psum_bits).to(out_dtype)


@register_grouped_backend("sharded")
def _sharded_grouped(plan, lin: PackedLinear, x: torch.Tensor,
                     offsets: torch.Tensor, max_rows: int, out_dtype):
    """Stacked experts, whole or this rank's slice of them: the wrapped
    backend's grouped form on the experts the rank holds (``offsets``
    counts those only), with no collective."""
    inner = get_grouped_backend(plan.inner_backend or "reference")
    if lin.shard not in (None, "expert"):
        raise ValueError(f"stacked experts cut as {lin.shard!r}; the mesh "
                         "splits them along the expert axis only")
    if offsets.shape[0] != lin.packed.shape[0] + 1:
        raise ValueError(
            f"{offsets.shape[0] - 1} expert groups for the "
            f"{lin.packed.shape[0]} experts this rank holds")
    return inner(plan, lin, x, offsets, max_rows, out_dtype)


def lane_partition(mesh, model_axis: str, n_kv_heads: int,
                   n_lanes: int) -> Tuple[Optional[int], int]:
    """``(heads per rank or None, lane shards)``: KV heads over
    ``model_axis`` when they divide it (None: heads replicate), and lanes
    over the data axes when ``n_lanes`` divides their product (1: lanes
    replicate), by :func:`~repro_torch.dist.sharding.paged_attn_partition`,
    the rule the JAX package's ``_batch_entry`` and ``shard_map`` specs
    follow."""
    head, lane = paged_attn_partition(mesh, model_axis, n_kv_heads, n_lanes)
    heads = None if head is None else n_kv_heads // mesh.count(head)
    return heads, (1 if lane is None else mesh.count(lane))


def sharded_paged_attention(q, k_pages, v_pages, block_tables, pos, window,
                            k_scale, v_scale, *, attn_backend: str,
                            prefill=None) -> torch.Tensor:
    """Paged attention on this rank's KV heads.

    The pool a rank holds is its KV-head slice ``(P, page, Hkv/m, Dh)``
    (``dist.sharding.cache_shardings``' heads over ``model``), and its
    queries are the matching ``Hq/m`` heads, the column-parallel ``wq``'s
    slice: the grouping ``G = Hq/Hkv`` is the same on every rank.
    Softmax is per head, so each rank runs the existing decode or
    chunked-prefill kernel on its slice and no collective is needed.

    The page axis is this rank's own: lanes over data draw their pages
    from their shard's range of the pool, and the block tables hold local
    page ids (the JAX package all-gathers the pool over the data axes
    before every kernel instead; ``serve/engine.py`` says why the port
    does not).

    ``prefill``: None runs the decode kernel (``pos`` is each lane's
    token count); ``dict(positions=..., pos0=..., seq_lens=...)`` the
    chunked prefill.
    """
    from repro_torch.models.attention import (
        attend_paged_decode,
        attend_paged_prefill,
    )

    hq, hkv = q.shape[-2], k_pages.shape[-2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over this rank's "
                         f"{hkv} KV heads")
    if prefill is None:
        return attend_paged_decode(q, k_pages, v_pages, block_tables, pos,
                                   window, k_scale=k_scale, v_scale=v_scale,
                                   attn_backend=attn_backend)
    return attend_paged_prefill(q, k_pages, v_pages, block_tables,
                                prefill["positions"], prefill["pos0"],
                                prefill["seq_lens"], window,
                                k_scale=k_scale, v_scale=v_scale,
                                attn_backend=attn_backend)
