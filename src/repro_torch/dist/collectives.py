"""The collectives of the mesh: exact and compressed sums, and gathers.

``psum_partial`` reduces the row-parallel partial GEMVs of the ``sharded``
engine backend: an exact float32 sum by default, or
``compressed_psum_leaf``'s narrow codes when the plan asks for them (the
JAX package's ``repro/dist/collectives.py``).  ``all_gather`` reassembles
a tensor sharded along one axis: the vocabulary slices of the head's
logits, the data shards' lanes, the blocks of :func:`~repro_torch.dist.
sharding.gather_shards`.

**Transport.**  The tensors go to ``torch.distributed`` as they are, on
their device.  Ranks sharing one card form a ``gloo`` group (NCCL refuses
two ranks on one device); ``gloo`` takes every collective used here on
CUDA tensors (``gloo_cuda_probe.py`` on the card: ``all_reduce``,
``all_gather_into_tensor`` and five more, torch 2.11) and moves them
through host memory itself.  A collective is a host call either way, so
a step that runs one cannot be captured in a CUDA graph.
"""

from __future__ import annotations

import time

import torch

# host seconds summed since the last reset: inside the collectives
# (SECONDS), and before them, waiting for the device to finish the work
# that produced their inputs (WAIT; a gloo call on a CUDA tensor waits
# for it anyway).  The serving engine reports both per step.
SECONDS = [0.0]
WAIT = [0.0]


def reset_seconds() -> None:
    SECONDS[0] = WAIT[0] = 0.0


def transport(mesh) -> str:
    """How the mesh's collectives travel, e.g. ``"gloo, 2 ranks on 1
    device"`` or ``"nccl, 4 ranks on 4 devices"``."""
    import torch.distributed as dist

    if mesh.device.type == "cuda":
        n = min(mesh.size, torch.cuda.device_count())
        where = f"{n} device{'s' if n > 1 else ''}"
    else:
        where = "the CPU"
    return f"{dist.get_backend()}, {mesh.size} ranks on {where}"


def _timed(call, x: torch.Tensor, *args, **kw):
    t0 = time.perf_counter()
    if x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()
    t1 = time.perf_counter()
    call(*args, **kw)
    WAIT[0] += t1 - t0
    SECONDS[0] += time.perf_counter() - t1


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced (``"sum"`` or ``"max"``) over the
    group; a 16-bit float tensor is reduced in float32."""
    import torch.distributed as dist

    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    buf = x.to(torch.float32) if x.dtype in (torch.bfloat16,
                                             torch.float16) else x.clone()
    buf = buf.contiguous()
    _timed(dist.all_reduce, buf, buf, op=rop, group=group)
    return buf.to(x.dtype)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` blocks concatenated along ``dim``, in group rank
    order (every block of one shape)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _timed(dist.all_gather_into_tensor, xt, out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def compressed_psum_leaf(x: torch.Tensor, group, bits: int = 8
                         ) -> torch.Tensor:
    """Sum over ``group`` carrying ``bits``-bit integer codes.

    The absmax is itself max-reduced, so every rank quantizes with one
    shared scale; the int8 codes are summed as int32 (exact: |q| ≤ qmax
    per participant) and dequantised.  The only loss is each
    participant's rounding, at most ``scale/2``, so ``|result − exact| ≤
    n · scale / 2`` for ``n`` ranks."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.to(torch.float32)
    absmax = all_reduce(xf.abs().amax(), group, op="max")
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    total = all_reduce(q.to(torch.int32), group)
    return (total.to(torch.float32) * scale).to(x.dtype)


def psum_partial(x: torch.Tensor, group, bits: int = 0) -> torch.Tensor:
    """Reduce row-parallel partial GEMVs over ``group``: an exact float32
    sum for ``bits=0`` (bit-identical to one device's accumulation
    whenever the partials are exact in float32), else
    :func:`compressed_psum_leaf` at 4 or 8 bits."""
    if bits:
        return compressed_psum_leaf(x, group, bits)
    return all_reduce(x.to(torch.float32), group).to(x.dtype)
