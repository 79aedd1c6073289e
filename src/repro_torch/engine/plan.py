"""``EnginePlan`` — the resolved dispatch object of the GEMV engine.

A plan is resolved once per run from an :class:`EngineConfig` and a device
(``resolve_plan``) and threaded through the model and the serving engine:
the GEMV backend, the digit radix, the KV precision and the attention read
path are pinned here.  Names are concrete, never ``"auto"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.engine.backends import (
    get_backend,
    get_grouped_backend,
    resolve_attn_backend,
    resolve_backend_name,
)
from repro_torch.engine.packed import as_packed, validate_bits


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """``backend``: GEMV registry name; ``bits``: weight precision used when
    packing (0 = dense weights on a kv-only plan); ``radix``: bits retired
    per bit-serial pass; ``kv_bits``: 0 or 8 (int8 KV pages);
    ``attn_backend``: ``gather`` or ``cuda``.  Outputs take the activation
    dtype.

    The ``sharded`` backend's fields (``engine/sharded.py``): ``mesh``,
    this rank's :class:`~repro_torch.dist.hints.Mesh` (None: the wrapped
    backend runs the whole weight); ``model_axis``, the axis the weights'
    bit-planes shard over; ``inner_backend``, the single-device backend
    each rank runs on its shard; ``psum_bits``, the row-parallel sum's
    precision (0 exact float32, 4/8 the compressed codes)."""

    backend: str
    bits: int
    radix: int = 1
    kv_bits: int = 0
    attn_backend: str = "gather"
    mesh: Any = None
    model_axis: str = "model"
    inner_backend: Optional[str] = None
    psum_bits: int = 0

    def __post_init__(self):
        if self.kv_bits not in (0, 8):
            raise ValueError(f"kv_bits must be 0/8, got {self.kv_bits}")
        if self.bits or not self.kv_bits:
            validate_bits(self.bits)  # bits=0 only on a kv-only plan
        if self.radix not in (1, 2, 4, 8):
            raise ValueError(f"radix must be 1/2/4/8, got {self.radix}")
        if self.bits % self.radix != 0:
            raise ValueError(
                f"radix {self.radix} must divide bits {self.bits}")
        if self.psum_bits not in (0, 4, 8):
            raise ValueError(
                f"psum_bits must be 0/4/8, got {self.psum_bits}")
        get_backend(self.backend)  # a typo fails here, not mid-step
        if self.attn_backend not in ("gather", "cuda"):
            raise KeyError(f"unknown attention backend {self.attn_backend!r}")
        if self.backend == "sharded":
            get_backend(self.inner_backend)
            if self.inner_backend == "sharded":
                raise ValueError(
                    "the sharded backend cannot wrap itself; pick a "
                    "single-device inner_backend")
            if (self.mesh is not None
                    and self.model_axis not in self.mesh.axis_names):
                raise ValueError(
                    f"model_axis {self.model_axis!r} not in mesh axes "
                    f"{tuple(self.mesh.axis_names)}")

    def apply(self, lin, x: torch.Tensor) -> torch.Tensor:
        """``y = x @ W [+ bias]`` for ``x`` of shape ``(..., in_features)``.

        Leading dimensions are flattened to ``(M, K)`` before dispatch, so
        the GEMV kernel runs for the serve path's ``(B, 1, D)`` and
        ``(B, C, D)`` activations too.
        """
        lin = as_packed(lin, bits_hint=self.bits)
        lead = tuple(x.shape[:-1])
        y = get_backend(self.backend)(self, lin, x.reshape(-1, x.shape[-1]),
                                      x.dtype)
        y = y.reshape(lead + (y.shape[-1],))
        if lin.bias is not None:
            y = y + lin.bias.to(y.dtype)
        return y

    def apply_grouped(self, lin, x: torch.Tensor, offsets: torch.Tensor,
                      max_rows: int) -> torch.Tensor:
        """Stacked experts ``(E, Kp, N)``: ``y[offsets[e]:offsets[e+1]] =
        x[...] @ W[e] * scale[e]`` for ``x`` ``(R, K)`` sorted by expert,
        ``offsets`` ``(E + 1,)`` int32 on x's device and ``max_rows`` a
        bound on any expert's rows fixed by the shapes (the kernel's launch
        is sized by it, never by the data).  Rows past ``offsets[E]`` are
        undefined; an expert's rows past ``max_rows`` are the caller's
        error.  ``(R, N)`` in x's dtype."""
        lin = as_packed(lin, bits_hint=self.bits)
        if lin.packed.ndim != 3 or x.ndim != 2:
            raise ValueError("apply_grouped: stacked (E, Kp, N) weights and "
                             f"(R, K) rows, got {tuple(lin.packed.shape)} "
                             f"and {tuple(x.shape)}")
        if lin.bias is not None:
            raise ValueError("apply_grouped: stacked experts carry no bias")
        return get_grouped_backend(self.backend)(self, lin, x, offsets,
                                                 max_rows, x.dtype)


def resolve_plan(cfg, *, device, mesh=None) -> Optional[EnginePlan]:
    """``EngineConfig`` (or None) -> ``EnginePlan`` (or None).

    None, or a config with ``weight_bits == 0`` and ``kv_bits == 0``,
    resolves to None: the plain dense path.  ``auto`` names resolve by
    ``device``.  With ``EngineConfig(sharded=True)`` the plan's backend is
    ``sharded`` and the configured backend becomes its ``inner_backend``;
    ``mesh`` (this rank's mesh, or None) rides in the plan.  A resolved
    plan is returned unchanged.
    """
    if cfg is None or isinstance(cfg, EnginePlan):
        return cfg
    if not cfg.enabled and not cfg.kv_bits:
        return None
    name, inner = resolve_backend_name(cfg.backend, device), None
    if cfg.sharded and name != "sharded":
        name, inner = "sharded", name
    return EnginePlan(
        backend=name,
        bits=cfg.weight_bits,
        radix=cfg.radix,
        kv_bits=cfg.kv_bits,
        attn_backend=resolve_attn_backend(cfg.attn_backend, device),
        mesh=mesh,
        inner_backend=inner,
        psum_bits=cfg.psum_bits,
    )


def plan_for_bits(bits: int, *, device) -> EnginePlan:
    """A standalone plan for a weight packed without a config."""
    return EnginePlan(backend=resolve_backend_name("auto", device),
                      bits=bits,
                      attn_backend=resolve_attn_backend("auto", device))
