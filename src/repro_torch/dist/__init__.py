"""Distribution layer: meshes of ranks, sharding rules, collectives.

  ``hints``        :class:`Mesh` over a ``torch.distributed`` world, the
                   mesh context and the model code's hints (no-ops: each
                   rank holds its shards explicitly)
  ``sharding``     name-based TP/FSDP param specs, batch/opt/cache specs,
                   and a rank's shards of a tree (``local_shard`` /
                   ``gather_shards``)
  ``collectives``  exact and int8-wire sums, gathers, the ring permute;
                   through host memory on a ``gloo`` group; and their
                   differentiable forms for tensor parallelism under
                   autograd (``copy_to``, ``sum_over``, ``gather_from``,
                   ``ppermute``)
  ``pipeline``     GPipe over the ``pod`` axis (``microbatch``,
                   ``stack_stages``, ``pipeline_apply``)
"""

from repro_torch.dist.collectives import (
    all_gather,
    compressed_psum_leaf,
    copy_to,
    gather_from,
    ppermute,
    psum_partial,
    sum_over,
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
from repro_torch.dist.pipeline import (
    microbatch,
    pipeline_apply,
    stack_stages,
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
    "copy_to",
    "gather_from",
    "gather_shards",
    "init_rank",
    "local_shard",
    "make_mesh",
    "microbatch",
    "opt_state_shardings",
    "param_shardings",
    "param_spec",
    "pipeline_apply",
    "ppermute",
    "psum_partial",
    "serve_param_specs",
    "shard_batch_seq",
    "shard_experts",
    "stack_stages",
    "sum_over",
    "transport",
    "use_mesh",
    "with_hint",
]
