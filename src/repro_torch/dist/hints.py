"""Meshes of ranks, the mesh context, and the model code's sharding hints.

The JAX package lays a ``(pod?, data, model)`` mesh over devices, places
whole arrays on it and lets XLA move the shards.  The port runs **one
process per rank**: each process holds only its own shards and runs the
same calls as every other rank, and the collectives are explicit
``torch.distributed`` calls (:mod:`repro_torch.dist.collectives`).

:class:`Mesh` is what the rest of the port sees of that world: named axes
laid over the ranks in row-major order (as ``jax.make_mesh`` lays
devices), ``axis_names`` and a name->size ``shape`` mapping (so every
name-and-shape rule of :mod:`repro_torch.dist.sharding` takes it as it
takes JAX's meshes), this rank's coordinate, one process subgroup per axis
and one over the data axes folded (``("pod", "data")``), and the rank's
device.

A **dry** mesh (:func:`dry_mesh`) is one rank's view with no world
behind it: its device is ``meta`` and its groups are :class:`DryGroup` s,
on which every collective of :mod:`repro_torch.dist.collectives` returns
an empty output of the right shape, tallies its bytes and communicates
nothing.  The dry run (``repro_torch.launch.dryrun``) counts a rank of a
``(16, 16)`` mesh this way on one host.

Since every rank holds its local shards explicitly, the hints
(:func:`with_hint` and its two users) have nothing left to constrain: they
keep the JAX package's names and signatures and return their input
unchanged.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device

AxisEntry = Union[None, str, Sequence[str]]

DATA_AXES = ("pod", "data")

_ACTIVE: list = []


def _axes_tuple(entry: AxisEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """This rank's view of a mesh of ranks.

    ``axis_names``: the axes in mesh order; ``shape``: name -> size, in the
    same order; ``rank`` / ``size``: the world rank and world size;
    ``coord``: name -> this rank's index along each axis; ``device``: the
    device this rank's shards live on.  :meth:`group` returns the process
    subgroup of the ranks that differ from this one only along the given
    axes, ordered by :meth:`index` along them.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int, device: torch.device, groups: Dict):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = int(rank)
        self.device = device
        coord, rest = {}, self.rank
        for name in reversed(self.axis_names):
            rest, coord[name] = divmod(rest, self.shape[name])
        self.coord = {name: coord[name] for name in self.axis_names}
        self._groups = groups

    def _ordered(self, axes: AxisEntry) -> Tuple[str, ...]:
        names = _axes_tuple(axes)
        unknown = [a for a in names if a not in self.shape]
        if unknown:
            raise KeyError(f"axes {unknown} not in mesh axes "
                           f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def count(self, axes: AxisEntry) -> int:
        """Ranks along ``axes`` (the product of their sizes; 1 for none)."""
        return math.prod(self.shape[a] for a in self._ordered(axes))

    def index(self, axes: AxisEntry) -> int:
        """This rank's row-major index along ``axes``: its block of an
        array sharded over them, and its rank in :meth:`group`."""
        idx = 0
        for a in self._ordered(axes):
            idx = idx * self.shape[a] + self.coord[a]
        return idx

    def group(self, axes: AxisEntry):
        """The process subgroup over ``axes`` (a name or a tuple of names)
        that holds this rank."""
        key = self._ordered(axes)
        try:
            return self._groups[key]
        except KeyError:
            raise KeyError(f"no process group over {key}; the mesh made "
                           f"groups over {sorted(self._groups)}") from None

    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in DATA_AXES if a in self.shape)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coord={self.coord}, "
                f"device={self.device})")


def _group_keys(axis_names: Tuple[str, ...]) -> Iterator[Tuple[str, ...]]:
    for a in axis_names:
        yield (a,)
    data = tuple(a for a in DATA_AXES if a in axis_names)
    if len(data) > 1:
        yield data


class DryGroup(NamedTuple):
    """A process group with no processes: the ``axes`` it spans, its
    ``size`` and this rank's ``index`` in it."""

    axes: Tuple[str, ...]
    size: int
    index: int


def dry_mesh(shape: Sequence[int], axis_names: Sequence[str],
             rank: int = 0, device: DeviceLike = "meta") -> Mesh:
    """Rank ``rank``'s :class:`Mesh` of a ``shape`` mesh with no
    ``torch.distributed`` world: one :class:`DryGroup` per axis (and over
    the data axes folded), on ``device`` (``meta``: shapes only)."""
    axis_names = tuple(axis_names)
    probe = Mesh(shape, axis_names, rank, torch.device(device), {})
    groups = {key: DryGroup(key, probe.count(key), probe.index(key))
              for key in _group_keys(axis_names)}
    return Mesh(shape, axis_names, rank, torch.device(device), groups)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device: DeviceLike = None,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """This rank's :class:`Mesh` over the initialised ``torch.distributed``
    world, whose size must equal the product of ``shape``; or, with
    ``ranks``, over those world ranks alone (in mesh order; their count
    the product of ``shape``), e.g. the survivors of a node loss
    (``ft.elastic``): a rank outside them gets None, and the mesh's
    ``rank`` is the rank's place in ``ranks``.

    Every rank must call this, in the same order as its other group
    creations: each axis's subgroups (and the folded data axes') are made
    collectively.  ``device``: where this rank's shards live; None picks
    the GPU, ``rank % device_count`` of them, so that ranks share the
    cards round-robin (raises on a host without CUDA, as the port's other
    entry points do).

    One process per rank is also what the CUDA launchers need: they set
    their kernels' shared-memory attributes once a process, through
    ``static`` flags in ``csrc/``, for the device the process first
    launched on.
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(see repro_torch.dist.init_rank)")
    axis_names = tuple(axis_names)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axes {axis_names} differ in "
                         "length")
    world, rank = dist.get_world_size(), dist.get_rank()
    members = list(range(world)) if ranks is None else [int(r) for r in
                                                        ranks]
    if members != sorted(set(members)):
        # a process group orders its ranks by world rank, and a rank's
        # index along the mesh must be its rank in the group
        raise ValueError(f"ranks must ascend without repeats: {members}")
    if math.prod(shape) != len(members):
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                         f"{math.prod(shape)} ranks; it is given "
                         f"{len(members)}")
    if device is None:
        resolve_device(None)  # raises on a host without CUDA
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    groups = {}
    for key in _group_keys(axis_names):
        idx = [axis_names.index(a) for a in key]
        others = [i for i in range(len(shape)) if i not in idx]
        # one subgroup for every setting of the other axes; each rank
        # keeps the one it belongs to
        for fixed in itertools.product(*(range(shape[i]) for i in others)):
            base = sum(c * strides[i] for c, i in zip(fixed, others))
            sub = sorted(members[base + sum(c * strides[i] for c, i in
                                            zip(inner, idx))]
                         for inner in itertools.product(
                             *(range(shape[i]) for i in idx)))
            g = dist.new_group(sub)
            if rank in sub:
                groups[key] = g
    if rank not in members:
        return None
    return Mesh(shape, axis_names, members.index(rank), device, groups)


def init_rank(rank: int, world: int, store_path: str, *,
              backend: Optional[str] = None) -> str:
    """Join a ``world``-rank ``torch.distributed`` group as ``rank``,
    meeting the others through a file store at ``store_path`` (a file in a
    temporary directory, so that concurrent groups on one host never
    collide on a port).  ``backend``: None picks ``nccl`` where there are
    at least ``world`` CUDA devices, else ``gloo`` (NCCL refuses two ranks
    on one device).  Returns the backend."""
    import torch.distributed as dist

    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= world else "gloo")
    dist.init_process_group(backend,
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    return backend


def close_rank() -> None:
    """Leave the group: wait for every rank, then tear it down (a rank
    that exits while others still talk to it aborts in ``gloo``'s
    threads)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the :func:`active_mesh` inside the block."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    """The mesh entered through :func:`use_mesh`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _filter_entry(entry: AxisEntry, dim: int, axes: dict) -> AxisEntry:
    """Keep only axis names that exist and whose product divides ``dim``."""
    if entry is None:
        return None
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    kept = []
    prod = 1
    for n in names:
        size = axes.get(n)
        if size is None:
            continue
        if dim % (prod * size) != 0:
            continue
        kept.append(n)
        prod *= size
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def with_hint(x: torch.Tensor, *entries: AxisEntry) -> torch.Tensor:
    """The JAX package's sharding constraint, ``P(*entries)`` on ``x``.
    A rank holds its shards explicitly, so there is nothing to constrain:
    ``x`` is returned as it is."""
    return x


def shard_batch_seq(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) activations: batch over the data axes (a no-op here, see
    :func:`with_hint`)."""
    return with_hint(x, DATA_AXES)


def shard_experts(x: torch.Tensor) -> torch.Tensor:
    """Expert-stacked tensor: the E axis over ``model`` (a no-op here, see
    :func:`with_hint`)."""
    if x.ndim >= 4:
        return with_hint(x, None, "model")
    return with_hint(x, "model")
