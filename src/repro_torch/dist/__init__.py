"""Distribution layer: meshes of ranks, sharding rules, collectives.

  ``hints``        :class:`Mesh` over a ``torch.distributed`` world, the
                   mesh context and the model code's hints (no-ops: each
                   rank holds its shards explicitly)
  ``sharding``     name-based TP/FSDP param specs, batch/opt/cache specs,
                   and a rank's shards of a tree (``local_shard`` /
                   ``gather_shards``)
  ``collectives``  exact and int8-wire sums, gathers; through host memory
                   on a ``gloo`` group

The JAX package's pipeline parallelism (``microbatch``, ``stack_stages``,
``pipeline_apply``) comes with training on a mesh.
"""

from repro_torch.dist.collectives import (
    all_gather,
    compressed_psum_leaf,
    psum_partial,
    transport,
)
from repro_torch.dist.hints import (
    Mesh,
    active_mesh,
    close_rank,
    init_rank,
    make_mesh,
    shard_batch_seq,
    shard_experts,
    use_mesh,
    with_hint,
)
from repro_torch.dist.sharding import (
    Spec,
    batch_shardings,
    cache_shardings,
    gather_shards,
    local_shard,
    opt_state_shardings,
    param_shardings,
    param_spec,
    serve_param_specs,
)

__all__ = [
    "Mesh",
    "Spec",
    "active_mesh",
    "all_gather",
    "close_rank",
    "batch_shardings",
    "cache_shardings",
    "compressed_psum_leaf",
    "gather_shards",
    "init_rank",
    "local_shard",
    "make_mesh",
    "opt_state_shardings",
    "param_shardings",
    "param_spec",
    "psum_partial",
    "serve_param_specs",
    "shard_batch_seq",
    "shard_experts",
    "transport",
    "use_mesh",
    "with_hint",
]
