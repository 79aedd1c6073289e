"""Production mesh geometry: the JAX package's ``repro/launch/mesh.py``.

Single pod: ``(data=16, model=16)``, 256 ranks.  Multi-pod: ``(pod=2,
data=16, model=16)``, 512 ranks; the ``pod`` axis carries data
parallelism.  A process is one rank (``repro_torch.dist``): over a
``torch.distributed`` world of that size :func:`make_production_mesh`
returns this rank's view, and with ``dry=True`` rank ``rank``'s view of
a mesh with no world behind it (``dist.hints.dry_mesh``: meta tensors,
collectives that only tally their bytes), which the dry run counts.
"""

from __future__ import annotations

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.hints import Mesh, dry_mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, dry: bool = False,
                         rank: int = 0, device: DeviceLike = None) -> Mesh:
    """This rank's view of the production mesh: over the initialised
    ``torch.distributed`` world (of 256 or 512 ranks), or with ``dry``
    rank ``rank``'s dry view on ``meta``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dry:
        return dry_mesh(shape, axes, rank)
    return make_mesh(shape, axes, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: DeviceLike = None) -> Mesh:
    """A small ``(data, model)`` mesh over the ranks there are (tests,
    examples, the card): each size cut to the world's, as JAX's is to its
    devices.  A ``(1, 1)`` mesh needs no process group: its groups are
    None, where no collective runs.  ``device``: None picks the GPU."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    data = min(data, n)
    model = min(model, max(1, n // data))
    if data * model == 1:
        return Mesh((1, 1), ("data", "model"), 0, resolve_device(device),
                    {("data",): None, ("model",): None})
    ranks = None if data * model == n else list(range(data * model))
    return make_mesh((data, model), ("data", "model"), device=device,
                     ranks=ranks)
