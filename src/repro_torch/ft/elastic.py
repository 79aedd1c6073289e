"""Elastic scaling: shrink the data-parallel extent of a mesh on node
loss, the JAX package's ``repro/ft/elastic.py``.

The ``model`` axis is never resized (weight shards would need a new
layout); lost capacity removes whole data-parallel replicas, e.g. from
(pod=2, data=16, model=16) to (data=16, model=16).  Every data-parallel
replica holds the same params and optimizer state, so resharding is a
re-placement that loses nothing, and the global batch is kept by raising
each replica's microbatch count (``grad_accum_factor``), so the step
before and after the shrink computes the same update.

:meth:`ElasticMeshManager.reshard` moves a tree of shards from the old
mesh onto a mesh of the surviving ranks (``make_mesh(ranks=)``, a new
``gloo`` group): the whole leaves are gathered over the old mesh, then
each survivor keeps its block under the new mesh's specs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from repro_torch.config.base import MeshConfig


@dataclass
class ElasticPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    grad_accum_factor: int  # multiply microbatches by this to keep global batch


class ElasticMeshManager:
    """Plans shrinks of ``mesh_cfg`` (a :class:`MeshConfig`, or anything
    with its ``shape`` and ``axis_names``)."""

    def __init__(self, mesh_cfg: MeshConfig):
        self.cfg = mesh_cfg

    def plan_shrink(self, lost_nodes: int,
                    chips_per_node: int = 4) -> ElasticPlan:
        """The largest valid mesh after losing ``lost_nodes``."""
        shape = list(self.cfg.shape)
        names = list(self.cfg.axis_names)
        lost_chips = lost_nodes * chips_per_node
        total = 1
        for s in shape:
            total *= s
        remaining = total - lost_chips
        if remaining <= 0:
            raise ValueError("no capacity left")

        model = shape[-1]                      # never resized
        data_like = remaining // model
        if data_like < 1:
            raise ValueError("cannot keep model axis intact")

        # collapse pod*data to the largest power-of-two <= data_like
        new_data = 1 << (data_like.bit_length() - 1)
        old_data = total // model
        factor = old_data // new_data
        if len(shape) == 3:
            # fold into (data, model) if a whole pod was lost, else shrink
            # data
            if new_data % shape[1] == 0 and new_data // shape[1] >= 1:
                new_shape = (new_data // shape[1], shape[1], model)
                new_names = tuple(names)
            else:
                new_shape = (new_data, model)
                new_names = (names[1], names[2])
        else:
            new_shape = (new_data, model)
            new_names = tuple(names)
        return ElasticPlan(tuple(shape), new_shape, new_names, factor)

    @staticmethod
    def reshard(tree: Any, old_mesh, new_mesh,
                spec_fn: Callable[[Any], Any]) -> Optional[Any]:
        """``tree``, this rank's shards on ``old_mesh``, as its shards on
        ``new_mesh`` (None on a rank that is not in it; every rank of the
        old mesh calls this).  ``spec_fn(mesh)`` gives the tree's spec
        tree on a mesh (JAX's takes a leaf's path and gives its spec; the
        port's placements are whole-tree rules, e.g. ``train.trainer.
        mesh_specs``)."""
        from repro_torch.dist.sharding import gather_shards, local_shard

        whole = gather_shards(tree, spec_fn(old_mesh), old_mesh)
        if new_mesh is None:
            return None
        return local_shard(whole, spec_fn(new_mesh), new_mesh)
