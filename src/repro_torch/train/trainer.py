"""Training loop: the train-step factory and a :class:`Trainer` that wires
the data pipeline, checkpoint manager, failure injection/restart and
straggler monitoring together, the JAX package's ``repro.train.trainer``.

``make_train_step`` builds the step: microbatched gradient accumulation in
float32, optional int8 error-feedback gradient compression, global-norm
clipping, the cosine-warmup LR and the chosen optimizer, in that order.

The training state — params, optimizer state, error-feedback buffer —
lives in the JAX package's layout (:func:`repro_torch.weights.stack_layers`:
each leaf under ``"layers"`` stacks the layers on axis 0), so the
optimizer and the compression see JAX's leaves (Adafactor factors, and
the compression scales, a stacked leaf as a whole) and a checkpoint names
its leaves as JAX's does: one written by either package resumes in the
other.  The forward pass gets per-layer views of the stacked leaves.

The loss runs ``forward(..., attn_backend="gather")``: the plain attention
and SSD paths, which is what the JAX package trains on (its Pallas flash
kernel is off by default and none of its kernels has a backward pass).
The CUDA kernels refuse inputs that require grad, and no backward kernel
is written.  Linears are float weights (``torch.matmul``), as in JAX.

**On a mesh** (``make_train_step(..., mesh=)``, one process a rank of a
``(data, model)`` mesh, tensor-parallel): the params and the optimizer
and error-feedback state are the rank's shards under :func:`mesh_specs`
(``dist.sharding.serve_param_specs`` on the stacked tree: whole heads,
experts over ``model``, SSM blocks whole; the state follows its params),
and the step takes the global batch and runs its data shard
(``batch_shardings``).  The forward crosses the model group through the
differentiable collectives, so a leaf whole on every model rank gets the
same whole gradient on each.  Each data shard's loss counts ``1/d`` of
its token mean (the moe family's aux loss, the whole batch's, once), the
gradients are summed over the data shards in float32, and the loss is
the global mean, as JAX's GSPMD step has them.  The global norm sums the
squares of the split leaves over the model group and counts a whole leaf
once; Adafactor and the compression's absmax reduce over the whole leaf
(``optim.LeafShards``).

**FSDP** (``mode="fsdp"``, the JAX package's ``train_cell``): the rank
stores its shards of the params and of the optimizer state under
:func:`mesh_specs`' ``"fsdp"`` placement, ``dist.sharding.
fsdp_param_specs`` (JAX's ``param_shardings(mode="fsdp")``: the data
axes on top of tensor parallelism).  The step gathers each layer's
leaves to the tensor-parallel placement above inside the layer's body
(:class:`LayerGather`), so a rank holds at most one layer's gathered
weights beyond its shards (remat gathers them again for the backward
pass); the other params are gathered once a microbatch.  A gather over
the data axes is ``dist.collectives.fsdp_gather``, whose backward sums
the data shards' gradients and leaves each rank its block
(``reduce_scatter``); a gather over ``model`` of a block the rank runs
whole is ``gather_from``, whose backward keeps the rank's block.  The
gradients of the leaves whole over the data axes are summed over them
as above.  AdamW and SGD update the local shards; the global norm counts
each leaf once over the data and model groups.  Adafactor and the
gradient compression, which reduce over a whole leaf, are not run under
FSDP (they raise).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, TrainConfig
from repro_torch.dist.collectives import all_reduce, fsdp_gather, gather_from
from repro_torch.dist.sharding import (
    Spec,
    batch_shardings,
    fsdp_param_specs,
    local_shard,
    meta_params,
    serve_param_specs,
    tree_map_with_path,
)
from repro_torch.models.transformer import chunked_ce, forward
from repro_torch.optim import (
    LeafShards,
    OptState,
    cosine_warmup,
    ef_state_init,
    error_feedback_compress,
    make_optimizer,
)
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import stack_layers

Tree = Any
F32 = torch.float32


def _square_sum(leaf: torch.Tensor) -> torch.Tensor:
    # a sum of squares, as JAX's: on the CPU ``torch.linalg.vector_norm``
    # of a 311 M-element float32 leaf (qwen2.5-3b's embedding) comes out
    # 0.1-0.3% low, where ``torch.sum`` sums in a cascade
    return torch.sum(torch.square(leaf.to(F32)))


def _global_norm(tree, shards=None) -> torch.Tensor:
    """The norm over every leaf; on a mesh (``shards``) the split leaves'
    squares are summed over the model group and a whole leaf counts
    once; under FSDP (:class:`FsdpSplit`) over every group a leaf is split
    over."""
    if isinstance(shards, FsdpSplit):
        return shards.norm(tree)
    if shards is None:
        return torch.sqrt(sum(_square_sum(leaf)
                              for leaf in tree_leaves(tree)))
    parts = {True: [], False: []}
    tree_map(lambda g, cut: parts[bool(cut)].append(_square_sum(g)), tree,
             shards.cuts)
    zero = torch.zeros((), dtype=F32, device=tree_leaves(tree)[0].device)
    split = all_reduce(sum(parts[True], zero), shards.group)
    return torch.sqrt(sum(parts[False], zero) + split)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled to global norm <= max_norm, in float32; the norm)``."""
    norm = _global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(F32) * scale, tree), norm


def _as_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Tensors on ``device`` (a numpy array copied: a memmap source's
    batch is a read-only view of the file)."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                ).to(device) for k, v in batch.items()}


def _grad_pieces(params: Tree, acc: Tree):
    """The forward's parameters as tensors that record gradients — one
    per leaf, and one per layer of a stacked leaf, each a view of the
    stacked storage — with the accumulator slice each one's gradient
    adds into."""
    pieces, slots = [], []

    def piece(p, a):
        t = p.detach().requires_grad_(True)
        pieces.append(t)
        slots.append(a)
        return t

    tree = {k: tree_map(piece, v, acc[k])
            for k, v in params.items() if k != "layers"}
    n = tree_leaves(params["layers"])[0].shape[0]
    tree["layers"] = [
        tree_map(lambda p, a, i=i: piece(p[i], a[i]), params["layers"],
                 acc["layers"]) for i in range(n)]
    return tree, pieces, slots


# elements of one all-reduce of the gradients over the data shards
_BUCKET = 1 << 26


def _sum_leaves(leaves, group) -> None:
    """Sum float32 ``leaves`` over ``group`` in place, a bucket of up to
    :data:`_BUCKET` elements a collective."""
    bucket: list = []

    def flush():
        if bucket:
            flat = all_reduce(torch.cat([t.reshape(-1) for t in bucket]),
                              group)
            for t, part in zip(bucket, torch.split(
                    flat, [t.numel() for t in bucket])):
                t.copy_(part.view_as(t))
            bucket.clear()

    size = 0
    for leaf in leaves:
        if size + leaf.numel() > _BUCKET:
            flush()
            size = 0
        bucket.append(leaf)
        size += leaf.numel()
    flush()


class FsdpSplit:
    """Where each FSDP storage shard is split: ``split``, a tree of the
    params' structure whose leaves are :class:`Spec` s of the mesh
    entries (axis names or tuples of them) the leaf is split over."""

    def __init__(self, split, mesh):
        self.split, self.mesh = split, mesh

    def groups(self, tree):
        """``{entries: [leaves]}``, in the tree's order (the same on every
        rank, so the collectives that follow line up)."""
        out: Dict[tuple, list] = {}
        tree_map_with_path(lambda path, g, s: out.setdefault(
            tuple(s), []).append(g), tree, self.split)
        return out

    def norm(self, tree) -> torch.Tensor:
        zero = torch.zeros((), dtype=F32, device=tree_leaves(tree)[0].device)
        total = zero
        for entries, leaves in self.groups(tree).items():
            part = sum((_square_sum(g) for g in leaves), zero)
            for entry in entries:
                part = all_reduce(part, self.mesh.group(entry))
            total = total + part
        return torch.sqrt(total)


def _data_entry(entry, mesh) -> bool:
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return all(n in mesh.data_axes() for n in names)


def _gather_plan(store: Spec, compute: Spec, mesh, first: int) -> tuple:
    """``((axis, entry), ...)``: the gathers that take a storage shard to
    the compute placement, axes counted from ``first`` (a stacked layer
    leaf's piece drops its layer axis)."""
    plan = []
    for ax, (s, c) in enumerate(zip(store, compute)):
        if s == c or s is None or mesh.count(s) == 1:
            continue
        if c is not None or ax < first:
            raise ValueError(f"FSDP storage {store} does not extend the "
                             f"compute placement {compute}")
        plan.append((ax - first, s))
    return tuple(plan)


def _gather_leaf(t: torch.Tensor, plan: tuple, mesh) -> torch.Tensor:
    for ax, entry in plan:
        group = mesh.group(entry)
        t = (fsdp_gather(t, group, ax) if _data_entry(entry, mesh)
             else gather_from(t, group, ax))
    return t


class LayerGather:
    """FSDP's gather of a layer's storage shards to the compute placement
    (``forward(gather=)``), and of the other params (:meth:`top`)."""

    def __init__(self, plans: Dict[tuple, tuple], mesh):
        self.plans, self.mesh = plans, mesh

    def _map(self, tree, prefix, fn):
        return tree_map_with_path(
            lambda path, t: fn(t, self.plans[prefix + tuple(path)]), tree)

    def __call__(self, lp):
        return self._map(lp, ("layers",), lambda t, plan: _gather_leaf(
            t, plan, self.mesh))

    def top(self, tree):
        return {k: (v if k == "layers" else self._map(
            v, (k,), lambda t, plan: _gather_leaf(t, plan, self.mesh)))
            for k, v in tree.items()}

    def shapes(self, lp):
        """The gathered shapes of a layer, as empty ``meta`` tensors."""
        def one(t, plan):
            shape = list(t.shape)
            for ax, entry in plan:
                shape[ax] *= self.mesh.count(entry)
            return torch.empty(shape, dtype=t.dtype, device="meta")
        return self._map(lp, ("layers",), one)


def mesh_specs(cfg: ModelConfig, tcfg: TrainConfig, mesh,
               mode: str = "tp") -> Dict[str, Any]:
    """The placement of the training state on ``mesh``: ``params`` (the
    stacked tree's :func:`~repro_torch.dist.sharding.serve_param_specs`),
    ``opt`` (the optimizer state's ``inner`` tree: AdamW's moments and
    SGD's momentum as their params, Adafactor's ``vr`` / ``vc`` as the
    axes of the param they keep) and ``ef`` (as the params).  Read from
    the shapes alone (``dist.sharding.meta_params``).

    ``mode="fsdp"``: the params and the state stored under
    :func:`~repro_torch.dist.sharding.fsdp_param_specs`, and ``compute``,
    the tensor-parallel placement above, which the step gathers them to
    (module docstring; AdamW and SGD only)."""
    if mode not in ("tp", "fsdp"):
        raise ValueError(f"mode must be tp/fsdp, got {mode!r}")
    shapes = stack_layers(meta_params(cfg))
    specs = serve_param_specs(mesh, shapes, cfg)
    if mode == "fsdp":
        if tcfg.optimizer == "adafactor" or tcfg.grad_compress_bits:
            raise NotImplementedError(
                "FSDP training runs AdamW or SGD without gradient "
                "compression: Adafactor's factored moments and the "
                "compression's absmax reduce over a whole leaf")
        store = fsdp_param_specs(mesh, shapes)
        opt = {"m": store, "v": store} if tcfg.optimizer == "adamw" \
            else store
        return {"params": store, "opt": opt, "ef": store, "compute": specs}
    if tcfg.optimizer == "adamw":
        opt = {"m": specs, "v": specs}
    elif tcfg.optimizer == "adafactor":
        def factored(path, spec):
            if len(spec) >= 2:
                return {"vr": Spec(spec[:-1]),
                        "vc": Spec(spec[:-2] + spec[-1:])}
            return {"v": spec}

        opt = tree_map_with_path(factored, specs)
    else:
        opt = specs
    return {"params": specs, "opt": opt, "ef": specs}


def shard_train_state(specs: Dict[str, Any], mesh, params, opt_state,
                      ef_state):
    """This rank's ``(params, opt_state, ef_state)`` from whole ones under
    :func:`mesh_specs`' ``specs`` (a leaf the rank holds whole is the
    input's tensor itself, not a copy)."""
    return (local_shard(params, specs["params"], mesh),
            OptState(opt_state.step,
                     local_shard(opt_state.inner, specs["opt"], mesh)),
            local_shard(ef_state, specs["ef"], mesh) if ef_state
            else ef_state)


def _make_grads(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                mode: str = "tp"):
    """``(grads, shards)``: ``grads(params, batch) -> (gradients, loss)``,
    the float32 gradients a step of :func:`make_train_step` applies
    (summed over the data shards on a mesh, before compression and
    clipping) with the global loss; ``shards`` the
    :class:`~repro_torch.optim.LeafShards` of the split leaves (None off a
    mesh, or with one model rank), or under FSDP the :class:`FsdpSplit`
    of the storage shards."""
    shards = data_group = gather = None
    n_data = 1
    if mesh is not None and mode == "fsdp":
        specs = mesh_specs(cfg, tcfg, mesh, mode="fsdp")
        plans: Dict[tuple, tuple] = {}
        tree_map_with_path(lambda path, s, c: plans.__setitem__(
            tuple(path), _gather_plan(
                s, c, mesh, 1 if path[0] == "layers" else 0)),
            specs["params"], specs["compute"])
        gather = LayerGather(plans, mesh)
        shards = FsdpSplit(tree_map_with_path(lambda path, s: Spec(
            e for e in s if e is not None and mesh.count(e) > 1),
            specs["params"]), mesh)
    elif mesh is not None and mesh.count("model") > 1:
        pspecs = mesh_specs(cfg, tcfg, mesh)["params"]
        shards = LeafShards(
            tree_map_with_path(lambda path, spec: tuple(
                ax for ax, e in enumerate(spec)
                if e is not None and mesh.count(e) > 1), pspecs),
            mesh.group("model"), mesh.count("model"))
    if mesh is not None:
        daxes = mesh.data_axes()
        n_data = mesh.count(daxes)
        if n_data > 1:
            data_group = mesh.group(daxes)

    def loss_of(params, batch):
        """(objective, its cross-entropy part, aux): the rank's share of
        the global loss, whose gradients summed over the data shards are
        the global loss's."""
        hidden, aux = forward(params, batch, cfg, remat=tcfg.remat,
                              return_hidden=True, attn_backend="gather",
                              mesh=mesh, gather=gather)
        ce = chunked_ce(params, hidden, batch["labels"], cfg,
                        mesh=mesh) / n_data
        return ce + aux, ce, aux

    def accumulate(acc, params, batch):
        if mesh is not None:
            batch = local_shard(batch, batch_shardings(mesh, batch), mesh)
        tree, pieces, slots = _grad_pieces(params, acc)
        with torch.enable_grad():
            if gather is not None:
                tree = gather.top(tree)
            loss, ce, aux = loss_of(tree, batch)
            grads = torch.autograd.grad(loss, pieces, allow_unused=True)
        with torch.no_grad():
            for a, g in zip(slots, grads):
                if g is not None:
                    a.add_(g)
        if data_group is None:
            return loss.detach()
        return torch.stack([ce.detach(), aux.detach()])

    def grads(params, batch):
        device = tree_leaves(params)[0].device
        batch = _as_batch(batch, device)
        mb = tcfg.microbatches
        # float32 from the start: for mb == 1 it holds the grads exactly
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                             device=p.device), params)
        if mb > 1:
            # JAX's split of the global batch: microbatch i holds global
            # rows [i B / mb, (i + 1) B / mb), and on a mesh each data
            # shard runs its block of those rows (the moe aux loss is not
            # linear in which rows share a microbatch)
            micros = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                      for k, v in batch.items()}
            loss = 0
            for i in range(mb):
                loss = loss + accumulate(
                    acc, params, {k: v[i] for k, v in micros.items()})
            loss = loss / mb
            for a in tree_leaves(acc):
                a.div_(mb)
        else:
            loss = accumulate(acc, params, batch)
        if data_group is not None:
            with torch.no_grad():
                # under FSDP the data-split leaves were summed by their
                # gathers' backward (reduce-scatter)
                _sum_leaves(tree_leaves(acc) if gather is None else [
                    g for entries, leaves in shards.groups(acc).items()
                    if not any(_data_entry(e, mesh) for e in entries)
                    for g in leaves], data_group)
                loss = all_reduce(loss[0], data_group) + loss[1]
        return acc, loss

    return grads, shards


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    donate: bool = True, mesh=None,
                    mode: str = "tp") -> Callable:
    """Returns ``step(params, opt_state, ef_state, batch) -> (params,
    opt_state, ef_state, metrics)``, params and states in the stacked
    layout, ``batch`` numpy arrays or tensors (moved to the params'
    device).  ``metrics``: ``loss``, ``grad_norm``, ``lr`` as 0-d float32
    tensors.

    The step updates the params and the optimizer state in place and
    returns them, as JAX's donated step reuses their buffers; ``donate``
    is accepted for JAX's signature and changes nothing.  ``ef_state`` is
    the error-feedback buffer when gradient compression is on (an empty
    dict otherwise).

    ``mesh``: this rank's mesh (module docstring).  ``params``, the
    states and the returned ones are then the rank's shards
    (:func:`shard_train_state`), ``batch`` the global batch, and the
    metrics the global ones, equal on every rank.  ``mode="fsdp"``: the
    params and states are the rank's FSDP storage shards (module
    docstring), placed by ``mesh_specs(..., mode="fsdp")``.
    """
    del donate
    _, update_fn = make_optimizer(tcfg.optimizer)
    grads, shards = _make_grads(cfg, tcfg, mesh, mode)

    def step(params, opt_state, ef_state, batch):
        acc, loss = grads(params, batch)
        with torch.no_grad():
            if tcfg.grad_compress_bits:
                acc, ef_state = error_feedback_compress(
                    acc, ef_state, tcfg.grad_compress_bits, shards)
            gnorm = _global_norm(acc, shards)
            scale = _clip_scale(gnorm, tcfg.grad_clip)
            for a in tree_leaves(acc):
                a.mul_(scale)
            lr = cosine_warmup(opt_state.step, tcfg.lr, tcfg.warmup_steps,
                               tcfg.total_steps)
            params, opt_state = update_fn(acc, opt_state, params, tcfg, lr,
                                          shards=shards)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, ef_state, metrics

    return step


class Trainer:
    """Step-loop driver with checkpoint/restart and straggler hooks.

    ``params`` in either layout (the port's per-layer list, from
    ``init_params``, is stacked here); ``self.params`` holds them stacked.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        params,
        pipeline,
        ckpt_manager=None,
        ckpt_every: int = 50,
        straggler_monitor=None,
        failure_injector=None,
    ):
        self.cfg, self.tcfg = cfg, tcfg
        if isinstance(params["layers"], list):
            params = stack_layers(params)
        self.params = params
        init_fn, _ = make_optimizer(tcfg.optimizer)
        self.opt_state = init_fn(params)
        self.ef_state = (ef_state_init(params) if tcfg.grad_compress_bits
                         else {})
        self.pipeline = pipeline
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.straggler = straggler_monitor
        self.injector = failure_injector
        self.step_fn = make_train_step(cfg, tcfg, donate=False)
        self.history: list = []
        self.restarts = 0

    def _state(self):
        return {"params": self.params, "opt": self.opt_state,
                "ef": self.ef_state}

    # -------------------------------------------------------------- resume
    def maybe_resume(self) -> int:
        if self.ckpt is None:
            return 0
        step, tree, extra = self.ckpt.restore_latest(self._state())
        if step is None:
            return 0
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.ef_state = tree["ef"]
        self.pipeline.state.step = int(extra.get("data_step", step))
        return step

    # ----------------------------------------------------------------- run
    def run(self, total_steps: int) -> Dict[str, list]:
        from repro_torch.ft.failures import run_with_restarts

        start = self.maybe_resume()

        def do_step(step: int):
            t0 = time.perf_counter()
            self.params, self.opt_state, self.ef_state, metrics = (
                self.step_fn(self.params, self.opt_state, self.ef_state,
                             self.pipeline.batch_at(step)))
            loss = float(metrics["loss"])
            self.history.append(loss)
            dt = time.perf_counter() - t0
            if self.straggler is not None:
                self.straggler.observe(step, {0: dt})
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, self._state(),
                               extra={"data_step": step + 1})

        def restore() -> int:
            step = self.maybe_resume()
            self.restarts += 1
            return step

        run_with_restarts(
            do_step, start_step=start, total_steps=total_steps,
            restore_fn=restore, injector=self.injector)
        if self.ckpt is not None:
            self.ckpt.wait()
        return {"loss": self.history}
