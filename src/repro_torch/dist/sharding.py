"""Sharding rules: name-based tensor-parallel specs for every param tree
of the zoo, the batch / optimizer-state / KV-cache specs, and the two
helpers that move a tree between its whole form and a rank's shards.

The rules are the JAX package's, rule for rule (``repro/dist/
sharding.py``): a leaf's key path decides the candidate axis
(column-parallel QKV/up projections shard their output axis, row-parallel
out/down projections their input axis, stacked MoE experts the expert
axis), and a divisibility check against the mesh decides whether the
shard happens; a dimension that does not divide degrades to replication,
never an error.  A spec is a tuple with one entry per dimension (None, an
axis name or a tuple of names), where JAX has a ``PartitionSpec``.

Trees are dicts, lists / tuples and the port's dataclasses
(``PackedLinear``, ``KVPages``), whose tensor fields are the leaves and
whose other fields ride along; a key path holds dict keys and field names
as strings and sequence indices as ints.  Every function takes any object
with ``axis_names`` and a ``shape`` name->size mapping: a
:class:`~repro_torch.dist.hints.Mesh` or a test stand-in.

:func:`local_shard` is the port's ``jax.device_put(tree, shardings)``:
each rank slices every leaf to its block.  :func:`gather_shards` is its
``jax.device_get``: the blocks reassembled (a collective, every rank
calls it).  :func:`serve_param_specs` is the placement the paged engine
serves by; it differs from :func:`param_shardings` only where a head
count does not divide the model axis (see there).  :func:`rank_shapes`
reads, from that placement, the shapes a rank's kernels run at.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

Pytree = Any


class Spec(tuple):
    """One entry per dimension: None (replicated), an axis name, or a
    tuple of axis names (a one-name tuple is kept as the name, as
    ``PartitionSpec`` keeps it); the port's ``PartitionSpec``.  A leaf of
    the spec trees (a plain tuple would be walked as a node)."""

    def __new__(cls, entries=()):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


# column-parallel (shard the output-feature axis): activations stay
# replicated, outputs become model-sharded.
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "lm_head"}
# row-parallel (shard the input-feature axis): consumes model-sharded
# activations; the partial products are summed over the model axis.
_ROW = {"wo", "w_down", "out_proj"}
_SPECIAL = {"embed"}
# engine PackedLinear leaves ride the rules of their owning linear.
_ENGINE_LEAVES = {"packed", "scale", "bias", "w"}

# decode-cache / page-pool leaves, by key name.  The stacked slot cache
# (L, B, T, Hkv, Dh) and the KVPages pool (L, P, page, Hkv, Dh) share one
# rule set: axis 1 (batch lanes or physical pages) shards over the data
# axes, the KV-head axis over ``model``.
_ATTN_KV_KEYS = {"k", "v", "k_global", "v_global", "k_local", "v_local"}
# int8-cache / quantized-page scale pools: trailing axis is the KV-head
# axis and must follow its K/V pool's head sharding.
_KV_SCALE_KEYS = {"k_scale", "v_scale"}
# host-built paged-serving index state (block tables, per-lane positions,
# lane-activity masks): lane axis over the data axes, never ``model``.
_PAGE_STATE_KEYS = {"block_tables", "pos", "active"}

_STACKED_CACHE_KEYS = (
    _ATTN_KV_KEYS | _KV_SCALE_KEYS | {"conv", "h"} | _PAGE_STATE_KEYS
)


# ---------------------------------------------------------------------------
# trees with key paths
# ---------------------------------------------------------------------------


def _is_leaf(x) -> bool:
    return isinstance(x, Spec) or (hasattr(x, "ndim")
                                   and hasattr(x, "shape"))


def tree_map_with_path(fn: Callable, tree: Pytree, *rest: Pytree,
                       _path: tuple = ()) -> Pytree:
    """``fn(path, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``, in a tree of the same structure (``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      _path=_path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        out = [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                  _path=_path + (i,))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {f.name: fn(_path + (f.name,), getattr(tree, f.name),
                              *(getattr(r, f.name) for r in rest))
                   for f in dataclasses.fields(tree)
                   if _is_leaf(getattr(tree, f.name))}
        return dataclasses.replace(tree, **changes)
    if tree is None:
        return None
    return fn(_path, tree, *rest)


def _mesh_sizes(mesh) -> dict:
    return dict(mesh.shape)


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _divisible_prefix(dim: int, axes: Tuple[str, ...], sizes: dict):
    """Longest prefix of ``axes`` whose size product divides ``dim``."""
    kept, prod = [], 1
    for a in axes:
        if dim <= 0 or dim % (prod * sizes[a]) != 0:
            break
        kept.append(a)
        prod *= sizes[a]
    return tuple(kept)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def param_spec(path, leaf, mesh, model_axis: str = "model") -> Spec:
    """Tensor-parallel spec for one param leaf, by key path."""
    ndim = getattr(leaf, "ndim", 0)
    spec = [None] * ndim
    sizes = _mesh_sizes(mesh)
    msize = sizes.get(model_axis)
    if not msize or ndim == 0:
        return Spec(spec)

    names = [str(k) for k in path]
    leafname = names[-1] if names else ""
    owner = next(
        (n for n in reversed(names) if n in _COL | _ROW | _SPECIAL), None)
    if owner is None:
        return Spec(spec)

    def put(ax: int):
        ax %= ndim
        if leaf.shape[ax] > 0 and leaf.shape[ax] % msize == 0:
            spec[ax] = model_axis

    stacked_experts = (
        "moe" in names
        and "shared" not in names
        and owner in _COL | _ROW
        and leafname in (owner, "packed", "scale")
        and ndim >= 3
    )
    if owner == "embed":
        if ndim >= 2:
            put(-2)  # vocab axis: (vocab, d) or audio (K, vocab, d)
    elif stacked_experts:
        put(ndim - 3)  # the expert axis of (..., E, D_in, D_out)
    elif owner in _COL:
        put(-1)
    elif owner in _ROW:
        if leafname == "bias":
            pass  # row-parallel bias spans the full output axis
        elif ndim >= 2:
            put(-2)
    return Spec(spec)


def _with_fsdp(spec: Spec, leaf, mesh, first: int = 0) -> Spec:
    """Layer ZeRO/FSDP on top of TP: shard the first still-replicated,
    divisible axis (from axis ``first`` on) over the data axes."""
    data_axes = _data_axes(mesh)
    if not data_axes:
        return spec
    sizes = _mesh_sizes(mesh)
    prod = 1
    for a in data_axes:
        prod *= sizes[a]
    if prod == 1:
        return spec
    entries = list(spec) + [None] * (leaf.ndim - len(spec))
    for ax in range(first, leaf.ndim):
        if entries[ax] is None and leaf.shape[ax] > 0 \
                and leaf.shape[ax] % prod == 0:
            entries[ax] = data_axes if len(data_axes) > 1 else data_axes[0]
            return Spec(entries)
    return spec


def param_shardings(mesh, params: Pytree, mode: str = "tp") -> Pytree:
    """Spec tree for a param tree.  ``mode``: "tp" | "fsdp"."""

    def one(path, leaf):
        spec = param_spec(path, leaf, mesh)
        if mode == "fsdp":
            spec = _with_fsdp(spec, leaf, mesh)
        return spec

    return tree_map_with_path(one, params)


def fsdp_param_specs(mesh, params: Pytree) -> Pytree:
    """The storage placement of FSDP training (``train.trainer``):
    :func:`param_shardings` in ``"fsdp"`` mode, with the data axes on a
    stacked layer leaf's own first divisible axis (JAX's rule on the
    layer's leaf, never the stacked layer axis 0), so that gathering one
    layer gathers that layer alone.  A rank holds as many bytes as under
    JAX's rule wherever a layer's leaf has a divisible axis of its own."""

    def one(path, leaf):
        spec = param_spec(path, leaf, mesh)
        return _with_fsdp(spec, leaf, mesh,
                          first=1 if path and path[0] == "layers" else 0)

    return tree_map_with_path(one, params)


def opt_state_shardings(mesh, opt_state: Pytree, mode: str = "tp") -> Pytree:
    """Optimizer/EF state specs: moment trees mirror the param tree's key
    names, so the same name-based rules apply; scalars replicate."""
    return param_shardings(mesh, opt_state, mode=mode)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def batch_shardings(mesh, batch: Pytree) -> Pytree:
    """Batch-axis sharding over the data axes (``("pod", "data")`` when the
    pod axis carries data parallelism)."""
    data_axes = _data_axes(mesh)
    sizes = _mesh_sizes(mesh)

    def one(path, leaf):
        ndim = getattr(leaf, "ndim", 0)
        if ndim == 0 or not data_axes:
            return Spec((None,) * ndim)
        kept = _divisible_prefix(leaf.shape[0], data_axes, sizes)
        return Spec((kept if kept else None,) + (None,) * (ndim - 1))

    return tree_map_with_path(one, batch)


def cache_shardings(mesh, cache: Pytree) -> Pytree:
    """Decode-cache specs: the batch (slot) axis over the data axes and KV
    heads over the model axis when divisible.

    Handles the stacked ``(L, B, ...)`` layout, the unstacked
    tuple-of-``(B, ...)`` layout, *and* the paged-serving ``KVPages``: its
    ``(L, P, page, Hkv, Dh)`` pools shard pages-over-data and
    heads-over-``model``, its scale pools follow their K/V pool's head
    sharding on the trailing axis, and block tables / positions / activity
    masks shard their lane axis over the data axes only.
    """
    data_axes = _data_axes(mesh)
    sizes = _mesh_sizes(mesh)
    msize = sizes.get("model", 0)

    def one(path, leaf):
        ndim = getattr(leaf, "ndim", 0)
        spec = [None] * ndim
        if ndim == 0:
            return Spec()
        names = [str(k) for k in path]
        # innermost cache-key name wins, so a KVPages (or cache dict)
        # nested inside a bigger serve-state tree keeps its rules.
        name = next(
            (n for n in reversed(names) if n in _STACKED_CACHE_KEYS),
            names[-1] if names else "")
        unstacked = any(isinstance(k, int) for k in path)
        batch_ax = 0 if (name in _PAGE_STATE_KEYS or unstacked
                         or ndim < 2) else 1
        kept = _divisible_prefix(leaf.shape[batch_ax], data_axes, sizes)
        if kept:
            spec[batch_ax] = kept
        head_ax = None
        if name in _ATTN_KV_KEYS and ndim >= 4:
            head_ax = -2                  # (..., T/page, Hkv, Dh)
        elif name in _KV_SCALE_KEYS and ndim >= 3:
            head_ax = -1                  # (..., T/page, Hkv)
        if (head_ax is not None and msize and leaf.shape[head_ax] > 0
                and leaf.shape[head_ax] % msize == 0):
            spec[head_ax] = "model"       # KV-head axis
        return Spec(spec)

    return tree_map_with_path(one, cache)


def paged_attn_partition(mesh, model_axis: str, n_kv_heads: int,
                         batch: int) -> Tuple[Any, Any]:
    """``(head_entry, lane_entry)``: the spec entries of the pool's KV-head
    axis and of the per-lane axes (queries, block tables, positions).
    Heads shard over ``model_axis`` exactly when it divides (matching
    :func:`cache_shardings`); lanes shard over the data axes when the
    batch divides.  Anything non-divisible degrades to replication (None),
    never an error."""
    sizes = _mesh_sizes(mesh)
    msize = sizes.get(model_axis, 1)
    head = (model_axis if msize > 1 and n_kv_heads > 0
            and n_kv_heads % msize == 0 else None)
    daxes = tuple(a for a in _data_axes(mesh) if a != model_axis)
    prod = 1
    for a in daxes:
        prod *= sizes[a]
    lane = None
    if prod > 1 and batch > 0 and batch % prod == 0:
        lane = daxes if len(daxes) > 1 else daxes[0]
    return head, lane


def pool_pages_for_mesh(n_pages: int, mesh) -> int:
    """Round a page-pool size up so the physical page axis shards evenly
    over the data axes; ``mesh=None`` (or no data axes) returns
    ``n_pages`` unchanged."""
    if mesh is None or n_pages <= 0:
        return n_pages
    sizes = _mesh_sizes(mesh)
    prod = 1
    for a in _data_axes(mesh):
        prod *= sizes[a]
    if prod <= 1:
        return n_pages
    return -(-n_pages // prod) * prod


# ---------------------------------------------------------------------------
# the serving placement
# ---------------------------------------------------------------------------

_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_MLP_KEYS = ("w_gate", "w_up", "w_down")


def _replicated(spec_tree: Pytree) -> Pytree:
    return tree_map_with_path(lambda p, s: Spec((None,) * len(s)),
                              spec_tree)


def serve_param_specs(mesh, params: Pytree, cfg,
                      model_axis: str = "model") -> Pytree:
    """The placement the serving engine runs by: :func:`param_shardings`
    (tp), with each block's shards kept whole-head and consistent.

    JAX's rule is by name and shape alone, so it splits ``wq``'s columns
    whenever ``Hq·Dh`` divides the model axis, heads or no heads, and XLA
    then moves data between the shards.  A rank here runs its kernels on
    its own shards with no resharding, so, block by block:

    * an attention block (a layer's, or the hybrid's ``shared_attn``)
      shards only when ``n_kv_heads`` divides the model axis (then
      ``n_heads`` does too) and every one of its linears shards by its
      rule; an MLP block (a layer's, a MoE layer's shared expert, the
      hybrid's shared one) only when all of its linears do;
    * a MoE layer's stacked experts shard their expert axis (codes and
      scales) only when all three of them do, by JAX's stacked-expert
      rule; the router stays whole;
    * an SSM block stays whole: ``in_proj``'s columns are the segments
      ``[z, x, B, C, dt]``, which a contiguous column slice cuts across,
      and the gated norm normalises over all of ``d_inner``;

    a block that fails its test is replicated on the mesh (all its specs
    None).  ``params["layers"]`` may be a list of layers or the training
    layout's stacked tree.  The embedding's vocabulary rows (axis −2: ``(V, D)``, or the
    audio family's ``(K, V, D)``) and an untied head's columns keep
    :func:`param_shardings`' spec.
    """
    specs = param_shardings(mesh, params)
    msize = _mesh_sizes(mesh).get(model_axis, 1)
    if msize <= 1:
        return specs

    def cut(lin_spec, axis) -> bool:
        """Is the linear's weight (its codes, when packed) sharded, along
        ``axis`` when one is named?"""
        main = lin_spec.packed if hasattr(lin_spec, "packed") \
            else lin_spec["w"] if isinstance(lin_spec, dict) else lin_spec
        if axis is None:
            return model_axis in main
        return main[axis] == model_axis

    def fix(block: dict, keys, ok: bool, axis=None) -> None:
        present = [k for k in keys if k in block]
        if not (ok and all(cut(block[k], axis) for k in present)):
            for k in present:
                block[k] = _replicated(block[k])

    heads_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % msize == 0
    layers = specs["layers"]
    # one dict per layer, or the training layout's one dict of stacked
    # leaves (``weights.stack_layers``), whose expert axis is then 1
    for lspec in layers if isinstance(layers, list) else [layers]:
        if "attn" in lspec:
            fix(lspec["attn"], _ATTN_KEYS, heads_ok)
        if "mlp" in lspec:
            fix(lspec["mlp"], _MLP_KEYS, True)
        if "moe" in lspec:
            moe = lspec["moe"]
            fix(moe, _MLP_KEYS, True, axis=-3)
            if "shared" in moe:
                fix(moe["shared"], _MLP_KEYS, True)
        if "ssm" in lspec:
            lspec["ssm"] = _replicated(lspec["ssm"])
    if "shared_attn" in specs:
        fix(specs["shared_attn"]["attn"], _ATTN_KEYS, heads_ok)
        fix(specs["shared_attn"]["mlp"], _MLP_KEYS, True)
    return specs


# ---------------------------------------------------------------------------
# whole tree <-> this rank's shards
# ---------------------------------------------------------------------------


def _blocks(entry, mesh) -> Tuple[int, int]:
    """(this rank's block index, block count) along one spec entry."""
    if entry is None:
        return 0, 1
    return mesh.index(entry), mesh.count(entry)


def local_shard(tree: Pytree, specs: Pytree, mesh) -> Pytree:
    """This rank's block of every leaf of ``tree`` under ``specs``, as new
    contiguous tensors (the whole leaves can then be freed).

    A ``PackedLinear`` comes back with its local feature counts and
    ``shard`` set to how it was split: ``"col"`` (output features over
    the model axis), ``"row"`` (packed rows, i.e. ``K·bits/8``, over the
    model axis), ``"expert"`` (a stacked ``(E, Kp, N)`` linear's
    contiguous slice of ``E/m`` experts, codes and scales; the rank's
    first expert is ``E/m`` times its model index) or None (whole on
    every rank).  A bias of a row-parallel linear spans the output and
    stays whole.
    """
    def one(path, leaf, spec):
        out = leaf
        for ax, entry in enumerate(spec):
            idx, n = _blocks(entry, mesh)
            if n > 1:
                size = leaf.shape[ax] // n
                out = out.narrow(ax, idx * size, size)
        # a copy even where the block is already contiguous (a slice of
        # the leading axis is a view that would keep the whole leaf alive)
        return (out.clone(memory_format=torch.contiguous_format)
                if out is not leaf else leaf)

    out = tree_map_with_path(one, tree, specs)
    return _stamp(out, specs, mesh)


def _stamp(tree: Pytree, specs: Pytree = None, mesh=None) -> Pytree:
    """Every PackedLinear with the feature counts of the codes it holds,
    and ``shard`` from its packed leaf's spec on ``mesh`` (None without
    ``specs``, or where every axis it names has size 1: a whole
    weight)."""
    from repro_torch.engine.packed import PackedLinear

    if isinstance(tree, PackedLinear):
        kind = None
        if specs is not None:
            cut = [_blocks(e, mesh)[1] > 1 for e in specs.packed]
            if tree.packed.ndim == 2:
                kind = "row" if cut[0] else ("col" if cut[1] else None)
            elif cut[0]:
                kind = "expert"     # stacked experts, a contiguous E slice
        return dataclasses.replace(
            tree, shard=kind,
            in_features=tree.packed.shape[-2] * (8 // tree.bits),
            out_features=tree.packed.shape[-1])
    if isinstance(tree, dict):
        return {k: _stamp(v, None if specs is None else specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_stamp(v, None if specs is None else specs[i], mesh)
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return tree


def gather_shards(tree: Pytree, specs: Pytree, mesh) -> Pytree:
    """Every leaf reassembled from the ranks' blocks under ``specs`` (a
    collective over each sharded leaf's axes: every rank calls it, with
    the same tree structure)."""
    from repro_torch.dist.collectives import all_gather

    def one(path, leaf, spec):
        out = leaf
        for ax in range(len(spec) - 1, -1, -1):
            entry = spec[ax]
            if _blocks(entry, mesh)[1] > 1:
                out = all_gather(out, mesh.group(entry), dim=ax)
        return out

    out = tree_map_with_path(one, tree, specs)
    return _stamp(out)


# ---------------------------------------------------------------------------
# a rank's kernel shapes
# ---------------------------------------------------------------------------


class RankShapes(NamedTuple):
    """The shapes one rank of a mesh gives the kernels: ``linears``, the
    ``(K, N)`` of every packed 2-D linear it holds (an untied head
    included); ``experts``, the ``(K, N, E_local)`` of every stacked
    expert linear; ``heads``, the ``(Hkv, G, Dh)`` of its attention
    blocks (None without one).  Each in the tree's order, without
    repeats."""

    linears: Tuple[Tuple[int, int], ...]
    experts: Tuple[Tuple[int, int, int], ...]
    heads: Optional[Tuple[int, int, int]]


def rank_shapes(cfg, shape: Tuple[int, ...],
                axis_names: Tuple[str, ...] = ("data", "model"),
                rank: int = 0, bits: int = 4) -> RankShapes:
    """The :class:`RankShapes` of ``rank`` of a ``shape`` mesh serving
    ``cfg`` with ``bits``-bit packed weights, read from the serving
    placement itself (:func:`serve_param_specs`, :func:`local_shard`) on
    a one-layer tree of ``cfg`` built under ``FakeTensorMode``: shapes
    only, no weight drawn and no memory taken.  Every layer of a family
    is cut alike, so one layer speaks for all."""
    return _rank_shapes(dataclasses.replace(cfg, n_layers=1),
                        tuple(shape), tuple(axis_names), rank, bits)


def _to_meta(tree: Pytree) -> Pytree:
    return tree_map_with_path(
        lambda path, t: torch.empty_strided(t.shape, t.stride(),
                                            dtype=t.dtype, device="meta"),
        tree)


@functools.lru_cache(maxsize=None)
def _one_layer(cfg, engine_bits: int) -> Pytree:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import init_params

    with FakeTensorMode():
        one = init_params(dataclasses.replace(cfg, n_layers=1),
                          torch.Generator(), engine_bits=engine_bits)
    return _to_meta(one)


def meta_params(cfg, engine_bits: int = 0) -> Pytree:
    """The whole param tree of ``cfg`` (``engine_bits`` packed, as
    ``init_params`` packs it) as new empty ``meta`` tensors: one layer
    drawn under ``FakeTensorMode`` (no weight, no memory; cached by
    config), its shapes given to every layer."""
    one = _one_layer(cfg, engine_bits)
    out = _to_meta(one)
    out["layers"] = [_to_meta(one["layers"][0])
                     for _ in range(cfg.n_layers)]
    return out


@functools.lru_cache(maxsize=None)
def _rank_shapes(one, shape, axis_names, rank, bits) -> RankShapes:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.hints import Mesh
    from repro_torch.engine.packed import PackedLinear
    from repro_torch.models import init_params

    mesh = Mesh(shape, axis_names, rank, torch.device("cpu"), {})
    with FakeTensorMode():
        params = init_params(one, torch.Generator(), engine_bits=bits)
        local = local_shard(params, serve_param_specs(mesh, params, one),
                            mesh)
    linears, experts, widths = {}, {}, {}

    def walk(node, path):
        if isinstance(node, PackedLinear):
            k, n = node.in_features, node.out_features
            if node.packed.ndim == 2:
                linears[k, n] = None
            else:
                experts[k, n, node.packed.shape[0]] = None
            widths.setdefault(path[-2:], n)
        elif isinstance(node, dict):
            for key, v in node.items():
                walk(v, path + (key,))
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, path)

    walk(local, ())
    heads = None
    if ("attn", "wq") in widths:
        dh = one.resolved_head_dim
        hq, hkv = widths["attn", "wq"] // dh, widths["attn", "wk"] // dh
        heads = (hkv, hq // hkv, dh)
    return RankShapes(tuple(linears), tuple(experts), heads)
