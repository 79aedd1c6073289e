"""GPipe-style pipeline parallelism over the ``pod`` axis of a mesh, the
JAX package's ``repro/dist/pipeline.py``.

Layers are split into ``n_stages`` contiguous stages, one a ``pod`` rank,
and microbatches stream through the fill / drain schedule: on each of
``n_micro + n_stages - 1`` ticks every stage applies its layers to what
it holds and :func:`~repro_torch.dist.collectives.ppermute` hands the
result to the next stage (bubble fraction ``(S-1)/(M+S-1)``).  The last
stage's outputs are summed over the ``pod`` group, so every rank returns
them.

:func:`pipeline_apply` is exact (the same arithmetic as running the
stages in turn) and differentiable: the permute's gradient travels the
reverse permute and the sum's is the identity, so gradients pipeline
backwards through the same schedule.  Each rank holds every stage's
params (``stack_stages``) and applies its own, ``staged[pod index]``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.dist.collectives import ppermute, sum_over
from repro_torch.dist.hints import active_mesh
from repro_torch.tree import tree_map

Pytree = Any


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (n_micro, B // n_micro, ...)."""
    b = x.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def stack_stages(tree: Pytree, n_stages: int) -> Pytree:
    """Reshape each (L, ...) leaf to (n_stages, L // n_stages, ...), one
    stage a ``pod`` rank."""

    def one(a):
        n = a.shape[0]
        if n % n_stages != 0:
            raise ValueError(
                f"layer count {n} not divisible by n_stages {n_stages}")
        return a.reshape((n_stages, n // n_stages) + tuple(a.shape[1:]))

    return tree_map(one, tree)


def _sequential(staged: Pytree, micros: torch.Tensor, stage_fn: Callable,
                n_stages: int) -> torch.Tensor:
    h = micros
    for s in range(n_stages):
        h = stage_fn(tree_map(lambda a, s=s: a[s], staged), h)
    return h


def pipeline_apply(staged: Pytree, micros: torch.Tensor,
                   stage_fn: Callable[[Pytree, torch.Tensor], torch.Tensor],
                   n_stages: int, axis_name: str = "pod") -> torch.Tensor:
    """Run ``micros`` (n_micro, mb, ...) through ``n_stages`` stages over
    the ``axis_name`` ranks of the active mesh (:func:`~repro_torch.dist.
    hints.use_mesh`); ``stage_fn(stage_params, h) -> h`` applies one
    stage's slice of layers.  Returns the (n_micro, mb, ...) outputs on
    every rank.  Without an active mesh with ``axis_name`` of size
    ``n_stages``: the exact sequential sweep, no collectives."""
    mesh = active_mesh()
    if (mesh is None or axis_name not in mesh.axis_names
            or mesh.shape[axis_name] != n_stages):
        return _sequential(staged, micros, stage_fn, n_stages)
    group = mesh.group(axis_name)
    sidx = mesh.index(axis_name)
    w = tree_map(lambda a: a[sidx], staged)
    n_micro = micros.shape[0]
    # ``where`` on a flag, not a Python branch: every rank's graph then
    # has the same permutes on the loss's path, so that the backward pass
    # runs the same reverse permutes, in the same order, on every rank
    first = torch.tensor(sidx == 0, device=micros.device)
    last = torch.tensor(sidx == n_stages - 1, device=micros.device)
    state = torch.zeros_like(micros[0])
    outputs = []
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t (past the last one, junk that never
        # reaches the collection window)
        x_in = torch.where(first, micros[min(t, n_micro - 1)], state)
        y = stage_fn(w, x_in)
        if t >= n_stages - 1:
            outputs.append(torch.where(last, y, torch.zeros_like(y)))
        state = ppermute(y, group)
    # only the last stage holds real outputs; the sum gives them to all
    return sum_over(torch.stack(outputs).to(micros.dtype), group)
