"""Optimizers over nested dicts of tensors, with the JAX package's
arithmetic (``repro.optim.optimizers``).

AdamW keeps float32 moments whatever the param dtype (the bf16-param +
fp32-state large-model recipe); Adafactor offers the memory-lean
alternative (factored second moment) for the 100B+ configs; SGD exists as
the trivial baseline and for tests.

An update runs under ``torch.no_grad()`` and writes the params and the
state **in place** (as JAX's donated train step reuses their buffers): it
returns the same tensors, with ``OptState.step`` a new 0-d int32 tensor.
The caller keeps a copy of anything it still needs from before the step.

On a mesh each rank updates its shards of the params and the state
(``shards``, a :class:`LeafShards`): AdamW and SGD are elementwise and
need nothing more; Adafactor's factored means and its update's RMS are
taken over the whole leaf, summing over the model group where the leaf
is split.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.tree import tree_leaves, tree_map

Tree = Any
F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor      # 0-d int32: updates taken
    inner: Tree


class LeafShards:
    """Where a rank's leaves are split: ``cuts``, a tree of the params'
    structure whose leaves are tuples of the axes split over ``group``
    (``size`` ranks; ``()`` for a leaf whole on every rank), e.g. from
    ``dist.sharding`` specs.  :meth:`mean` reduces over the whole leaf
    from a rank's block."""

    def __init__(self, cuts: Tree, group, size: int):
        self.cuts, self.group, self.size = cuts, group, size

    def mean(self, x: torch.Tensor, cut, dims=None) -> torch.Tensor:
        """``torch.mean(x, dims)`` (all dims for None) of the whole leaf
        from this rank's block ``x``, split along the axes ``cut``: the
        block's sums added over the group where a reduced axis is
        split."""
        from repro_torch.dist.collectives import all_reduce

        dims = tuple(range(x.ndim)) if dims is None else dims
        if not any(d % x.ndim in cut for d in dims):
            return torch.mean(x, dims)
        n = 1
        for d in dims:
            n *= x.shape[d] * (self.size if d % x.ndim in cut else 1)
        return all_reduce(torch.sum(x, dims), self.group) / n


def _step0(params: Tree) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def _write(p: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    p.copy_(new.to(p.dtype))
    return p


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params: Tree) -> OptState:
    return OptState(step=_step0(params),
                    inner={"m": tree_map(_zeros32, params),
                           "v": tree_map(_zeros32, params)})


@torch.no_grad()
def adamw_update(grads: Tree, state: OptState, params: Tree,
                 cfg: TrainConfig, lr: torch.Tensor,
                 shards: Optional[LeafShards] = None
                 ) -> Tuple[Tree, OptState]:
    step = state.step + 1
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    c1 = 1.0 - b1 ** step.to(F32)
    c2 = 1.0 - b2 ** step.to(F32)

    def upd(p, g, m, v):
        # JAX's expression, in place where the rounding is the same: a
        # few leaf-sized temporaries at a time
        g = g.to(F32)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
        pf = p.to(F32)
        delta.add_(cfg.weight_decay * pf)
        return _write(p, pf.sub_(lr * delta))

    tree_map(upd, params, grads, state.inner["m"], state.inner["v"])
    return params, OptState(step, state.inner)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; memory-lean for 100B+ params)
# ---------------------------------------------------------------------------


def adafactor_init(params: Tree) -> OptState:
    def make(p):
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=F32, device=p.device)}
        return {"v": _zeros32(p)}

    return OptState(step=_step0(params), inner=tree_map(make, params))


def _factored_leaves(params: Tree, state: Tree, cuts: Tree = None):
    """(param, its state dict, its cut axes) triples: the state tree has a
    dict where the param tree has a leaf; ``cuts`` a tuple (``()`` without
    a tree of cuts)."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _factored_leaves(params[k], state[k],
                                        None if cuts is None else cuts[k])
    elif isinstance(params, (list, tuple)):
        for i, (p, s) in enumerate(zip(params, state)):
            yield from _factored_leaves(p, s,
                                        None if cuts is None else cuts[i])
    elif params is not None:
        yield params, state, () if cuts is None else cuts


@torch.no_grad()
def adafactor_update(grads: Tree, state: OptState, params: Tree,
                     cfg: TrainConfig, lr: torch.Tensor,
                     shards: Optional[LeafShards] = None
                     ) -> Tuple[Tree, OptState]:
    step = state.step + 1
    decay = 1.0 - step.to(F32) ** -0.8
    eps = 1e-30
    sh = shards or LeafShards(None, None, 1)
    triples = list(_factored_leaves(params, state.inner, sh.cuts))
    for (p, s, cut), g in zip(triples, tree_leaves(grads)):
        g = g.to(F32)
        g2 = g * g + eps
        if p.ndim >= 2:
            vr = decay * s["vr"] + (1 - decay) * sh.mean(g2, cut, (-1,))
            vc = decay * s["vc"] + (1 - decay) * sh.mean(g2, cut, (-2,))
            # vr's last axis is the leaf's axis -2
            vr_cut = tuple(a for a in cut if a < p.ndim - 1)
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / torch.clamp(sh.mean(vr, vr_cut, (-1,))[..., None, None],
                              min=eps))
            upd_ = g / torch.clamp(denom, min=eps)
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = decay * s["v"] + (1 - decay) * g2
            upd_ = g / (torch.sqrt(v) + 1e-8)
            s["v"].copy_(v)
        # update clipping (RMS <= 1) as in the Adafactor paper
        rms = torch.sqrt(sh.mean(upd_ * upd_, cut) + eps)
        upd_ = upd_ / torch.clamp(rms, min=1.0)
        pf = p.to(F32)
        _write(p, pf - lr * (upd_ + cfg.weight_decay * pf))
    return params, OptState(step, state.inner)


# ---------------------------------------------------------------------------
# SGD (+momentum)
# ---------------------------------------------------------------------------


def sgd_init(params: Tree) -> OptState:
    return OptState(step=_step0(params), inner=tree_map(_zeros32, params))


@torch.no_grad()
def sgd_update(grads: Tree, state: OptState, params: Tree,
               cfg: TrainConfig, lr: torch.Tensor,
               shards: Optional[LeafShards] = None
               ) -> Tuple[Tree, OptState]:
    def upd(p, g, m):
        m.mul_(cfg.beta1).add_(g.to(F32))
        return _write(p, p.to(F32) - lr * m)

    tree_map(upd, params, grads, state.inner)
    return params, OptState(state.step + 1, state.inner)


_OPTIMIZERS: Dict[str, Tuple[Callable, Callable]] = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
    "sgd": (sgd_init, sgd_update),
}


def make_optimizer(name: str) -> Tuple[Callable, Callable]:
    if name not in _OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}: {sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[name]
