"""The collectives of the mesh: exact and compressed sums, gathers, the
ring permute, and the differentiable forms of tensor parallelism.

``psum_partial`` reduces the row-parallel partial GEMVs of the ``sharded``
engine backend: an exact float32 sum by default, or
``compressed_psum_leaf``'s narrow codes when the plan asks for them (the
JAX package's ``repro/dist/collectives.py``).  ``all_gather`` reassembles
a tensor sharded along one axis: the vocabulary slices of the head's
logits, the data shards' lanes, the blocks of :func:`~repro_torch.dist.
sharding.gather_shards`.  :func:`reduce_scatter` sums a tensor over the
group and leaves each rank its block (FSDP's gradients).

**Counting.**  Every collective tallies its output bytes into the active
op counter (``roofline.op_cost.collective``) under JAX's family names
(``all-reduce``, ``all-gather``, ``reduce-scatter``,
``collective-permute``), on a real group and a dry one alike; a group of
one rank moves nothing and tallies nothing.  On a
:class:`~repro_torch.dist.hints.DryGroup` (a dry mesh) each returns an
empty output of the right shape and communicates nothing.

**Transport.**  The tensors go to ``torch.distributed`` as they are, on
their device.  Ranks sharing one card form a ``gloo`` group (NCCL refuses
two ranks on one device); ``gloo`` takes every collective used here on
CUDA tensors (``gloo_cuda_probe.py`` on the card: ``all_reduce``,
``all_gather_into_tensor`` and five more, torch 2.11) and moves them
through host memory itself.  A ``gloo`` call is a host call, which a
CUDA graph cannot hold.

**Segment breaks.**  A serving step on a mesh is captured as a sequence
of graphs instead (``serve/step_graph.py`` ``SegmentedStepGraph``), cut
at its collectives.  While such a capture is open (:func:`cutting`),
:func:`all_reduce` and :func:`all_gather` call no ``torch.distributed``:
each one prepares its buffer in the current segment, hands the capture
the host step that will run the collective on that buffer (the same
``dist`` call on the same tensor), and goes on in the next segment, which
captures the rest of the function.  A replay runs the segments in order
with their host steps between them.  A group of one sums and gathers
nothing and cuts nothing.  :func:`reduce_scatter` and the ring permute
are not on the serving path and raise inside such a capture.  Nothing
inside a capture synchronises the stream: the host step's wait for its
segment's device work (``WAIT``) happens at replay.

**Under autograd** (training on a mesh) the model code calls the
differentiable forms at the end of this module: :func:`copy_to` ahead
of a column-parallel block, :func:`sum_over` after a row-parallel one,
:func:`gather_from` for a sharded output, :func:`ppermute` between
pipeline stages.  Without autograd recording each is its plain call.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Optional

import torch

from repro_torch.dist.hints import DryGroup
from repro_torch.roofline import op_cost

# host seconds summed since the last reset: inside the collectives
# (SECONDS), and before them, waiting for the device to finish the work
# that produced their inputs (WAIT; a gloo call on a CUDA tensor waits
# for it anyway).  The serving engine reports both per step.
SECONDS = [0.0]
WAIT = [0.0]


# the open segmented captures' cut functions, innermost last
_CUTS: list = []


def reset_seconds() -> None:
    SECONDS[0] = WAIT[0] = 0.0


def backend() -> Optional[str]:
    """The ``torch.distributed`` backend of this process's world (None
    outside one)."""
    import torch.distributed as dist

    return dist.get_backend() if dist.is_initialized() else None


@contextlib.contextmanager
def cutting(cut: Callable[[Callable[[], None]], None]):
    """Inside the block the collectives end the current graph segment:
    each calls ``cut(host_step)`` in place of its ``torch.distributed``
    call, where ``host_step()`` runs that call (timed, as outside) and
    ``cut`` closes the segment, keeps the host step and opens the next."""
    _CUTS.append(cut)
    try:
        yield
    finally:
        _CUTS.pop()


def transport(mesh) -> str:
    """How the mesh's collectives travel, e.g. ``"gloo, 2 ranks on 1
    device"`` or ``"nccl, 4 ranks on 4 devices"``."""
    if mesh.device.type == "cuda":
        n = min(mesh.size, torch.cuda.device_count())
        where = f"{n} device{'s' if n > 1 else ''}"
    else:
        where = "the CPU"
    return f"{backend()}, {mesh.size} ranks on {where}"


def _timed(call, x: torch.Tensor, *args, **kw):
    t0 = time.perf_counter()
    if x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()
    t1 = time.perf_counter()
    call(*args, **kw)
    WAIT[0] += t1 - t0
    SECONDS[0] += time.perf_counter() - t1


def _host_call(n: int, call, x: torch.Tensor, *args, **kw) -> None:
    """Run the collective ``call`` on a group of ``n`` ranks now, or,
    inside a segmented capture, hand it to the capture as the host step
    between two segments (a group of one: no step and no cut)."""
    if not _CUTS:
        _timed(call, x, *args, **kw)
    elif n > 1:
        _CUTS[-1](functools.partial(_timed, call, x, *args, **kw))


def _refuse_in_capture(what: str) -> None:
    if _CUTS:
        raise RuntimeError(
            f"{what} inside a segmented graph capture: only all_reduce and "
            "all_gather cut a serving step into segments")


def _group_size(group) -> int:
    """Ranks of ``group`` (a process group, None for the world, or a
    :class:`~repro_torch.dist.hints.DryGroup`)."""
    if isinstance(group, DryGroup):
        return group.size
    import torch.distributed as dist

    return dist.get_world_size(group)


def _nbytes(x: torch.Tensor, dtype=None) -> int:
    return x.numel() * (x.element_size() if dtype is None else dtype.itemsize)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced (``"sum"`` or ``"max"``) over the
    group; a 16-bit float tensor is reduced in float32."""
    wide = x.dtype in (torch.bfloat16, torch.float16)
    n = _group_size(group)
    n_bytes = _nbytes(x, torch.float32 if wide else None) if n > 1 else 0
    with op_cost.collective("all-reduce", n_bytes, n_bytes):
        if isinstance(group, DryGroup):
            return x.clone() if n == 1 else torch.empty_like(x)
        import torch.distributed as dist

        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = x.to(torch.float32) if wide else x.clone()
        buf = buf.contiguous()
        _host_call(n, dist.all_reduce, buf, buf, op=rop, group=group)
        return buf.to(x.dtype)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` blocks concatenated along ``dim``, in group rank
    order (every block of one shape)."""
    n = _group_size(group)
    if n == 1:
        return x
    with op_cost.collective("all-gather", n * _nbytes(x), _nbytes(x)):
        shape = list(x.shape)
        shape[dim] *= n
        if isinstance(group, DryGroup):
            return torch.empty(shape, dtype=x.dtype, device=x.device)
        import torch.distributed as dist

        xt = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _host_call(n, dist.all_gather_into_tensor, xt, out, xt,
                   group=group)
        return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` summed over the group, this rank's block along ``dim`` (``x``'s
    size there divided by the group's; a 16-bit float summed in float32
    and returned in its dtype).  On ``gloo``, which has no reduce-scatter,
    it travels as an all-reduce of which each rank keeps its block; it is
    counted as the reduce-scatter it computes."""
    n = _group_size(group)
    if n == 1:
        return x
    _refuse_in_capture("reduce_scatter")
    block = x.shape[dim] // n
    wide = x.dtype in (torch.bfloat16, torch.float16)
    out_bytes = _nbytes(x, torch.float32 if wide else None) // n
    with op_cost.collective("reduce-scatter", out_bytes, n * out_bytes):
        if isinstance(group, DryGroup):
            shape = list(x.shape)
            shape[dim] = block
            return torch.empty(shape, dtype=x.dtype, device=x.device)
        import torch.distributed as dist

        buf = (x.to(torch.float32) if wide else x.clone()).contiguous()
        _timed(dist.all_reduce, buf, buf, op=dist.ReduceOp.SUM,
               group=group)
        return buf.narrow(dim, _group_rank(group) * block, block).to(
            x.dtype).contiguous()


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


# ---------------------------------------------------------------------------
# differentiable forms (tensor parallelism under autograd)
# ---------------------------------------------------------------------------
#
# The usual pairs of a tensor-parallel layer: ahead of a column-parallel
# linear the replicated input passes through :func:`copy_to` (its
# gradient, partial on each rank, is summed over the group); after a
# row-parallel one the partials are summed by :func:`sum_over` (each
# rank's partial takes the whole gradient); :func:`gather_from`
# reassembles a sharded output (each rank keeps its slice of the
# gradient); :func:`ppermute` hands a tensor round a ring (its gradient
# goes the other way).  Without autograd recording each is the plain
# call: the same collective, nothing more.

# point-to-point calls made by :func:`ppermute`, forward and backward
P2P_CALLS = [0]


def _recording(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _group_rank(group) -> int:
    if isinstance(group, DryGroup):
        return group.index
    import torch.distributed as dist

    return dist.get_rank(group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = _group_rank(group)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; under autograd its gradient is summed over
    ``group`` (None: no group, ``x`` itself)."""
    if group is None or not _recording(x):
        return x
    return _CopyTo.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_reduce` of ``x`` over ``group`` (a 16-bit float summed in
    float32, returned in its dtype); under autograd each rank's partial
    takes the whole gradient."""
    if not _recording(x):
        return all_reduce(x, group)
    return _SumOver.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` of ``x`` along ``dim``; under autograd each rank
    keeps its own block of the gradient."""
    if not _recording(x):
        return all_gather(x, group, dim)
    return _GatherFrom.apply(x, group, dim)


def fsdp_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """FSDP's gather of a parameter's shards: :func:`all_gather` of ``x``
    along ``dim``; under autograd the gradient, partial on each rank (a
    data shard's), is summed over the group and each rank keeps its block
    (:func:`reduce_scatter`)."""
    if not _recording(x):
        return all_gather(x, group, dim)
    return _FsdpGather.apply(x, group, dim)


def _permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` places on in ``group``'s order and
    return what the rank ``shift`` places back sent (through host memory,
    as the other collectives travel on ``gloo``)."""
    n = _group_size(group)
    if n == 1:
        return x
    _refuse_in_capture("the ring permute")
    with op_cost.collective("collective-permute", _nbytes(x), _nbytes(x)):
        P2P_CALLS[0] += 1
        if isinstance(group, DryGroup):
            return torch.empty_like(x)
        import torch.distributed as dist

        me = _group_rank(group)
        dst = dist.get_global_rank(group, (me + shift) % n)
        src = dist.get_global_rank(group, (me - shift) % n)
        host = x.detach().to("cpu").contiguous()
        out = torch.empty_like(host)

        def exchange():
            reqs = [dist.isend(host, dst), dist.irecv(out, src)]
            for r in reqs:
                r.wait()

        _timed(exchange, x)
        return out.to(x.device)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """The ring permute ``i -> i + shift`` over ``group`` (JAX's
    ``lax.ppermute`` with ``perm = [(i, (i + shift) % n)]``): every rank
    sends ``x`` on and returns what it received; under autograd the
    gradient travels the reverse permute."""
    if not _recording(x):
        return _permute(x, group, shift)
    return _Permute.apply(x, group, shift)
