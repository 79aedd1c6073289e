"""Backend registry of the GEMV engine and the attention read paths.

A GEMV backend is ``fn(plan, lin, x, out_dtype) -> y`` with ``x`` of shape
``(M, K)`` (``EnginePlan.apply`` flattens leading dimensions first, so the
kernel runs for 3-D serve activations too).  Each has a grouped twin for
stacked expert weights, ``fn(plan, lin, x, offsets, max_rows, out_dtype)``
(``EnginePlan.apply_grouped``): ``x`` ``(R, K)`` holds rows sorted by
expert, ``offsets`` ``(E + 1,)`` int32 on x's device bounds expert e's
rows ``[offsets[e], offsets[e+1])``, ``max_rows`` is a static bound on any
expert's rows, and ``y[rows of e] = x[rows of e] @ W[e] * scale[e]``;
rows past ``offsets[E]`` are undefined.  Shipped backends:

  ``reference``   unpack + one float32 product; exact, runs anywhere.
  ``bit_serial``  explicit radix-digit walk, the FPGA-faithful twin of
                  ``reference``.
  ``cuda``        the hand-written CUDA kernel
                  (``repro_torch.kernels.bitplane_gemv``).

Attention read paths: ``gather`` (materialise the logical KV view, then
attend; the reference) and ``cuda`` (the in-place paged kernels).  The
same name picks the sequence mixers of the full-sequence path: ``cuda``
runs the flash-attention and SSD-scan kernels, ``gather`` their plain
versions.

``auto`` resolves by device: ``cuda`` for a CUDA device, ``reference`` /
``gather`` for the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core.bitplane import unpack_weights
from repro_torch.engine.packed import PackedLinear
from repro_torch.kernels._gemv import expert_slots, gather_slots, scatter_slots

BackendFn = Callable[..., torch.Tensor]

_REGISTRY: Dict[str, BackendFn] = {}
_GROUPED: Dict[str, BackendFn] = {}

AUTO = "auto"
ATTN_BACKENDS = ("gather", "cuda")


def register_backend(name: str, fn: BackendFn = None):
    """Register ``fn`` as engine backend ``name`` (usable as a decorator)."""
    if fn is None:
        return lambda f: register_backend(name, f)
    if not isinstance(name, str) or not name:
        raise ValueError(f"backend name must be a non-empty string: {name!r}")
    _REGISTRY[name] = fn
    return fn


def register_grouped_backend(name: str):
    """Register the grouped twin of backend ``name`` (a decorator)."""
    def deco(fn):
        _GROUPED[name] = fn
        return fn
    return deco


def get_grouped_backend(name: str) -> BackendFn:
    try:
        return _GROUPED[name]
    except KeyError:
        raise KeyError(f"engine backend {name!r} has no grouped (stacked "
                       f"expert) form; available: {sorted(_GROUPED)}"
                       ) from None


def get_backend(name: str) -> BackendFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown engine backend {name!r}; available: "
                       f"{sorted(_REGISTRY)}") from None


def _on_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def resolve_backend_name(name: str, device) -> str:
    if name in (AUTO, None, ""):
        name = "cuda" if _on_cuda(device) else "reference"
    if name not in _REGISTRY:
        raise KeyError(f"unknown engine backend {name!r}; available: "
                       f"{sorted(_REGISTRY)}")
    return name


def resolve_attn_backend(name: str, device) -> str:
    if name in (AUTO, None, ""):
        name = "cuda" if _on_cuda(device) else "gather"
    if name not in ATTN_BACKENDS:
        raise KeyError(f"unknown attention backend {name!r}; available: "
                       f"{sorted(ATTN_BACKENDS)}")
    return name


@register_backend("reference")
def _reference(plan, lin: PackedLinear, x: torch.Tensor, out_dtype):
    """Unpack + one float32 product; exact for b <= 8."""
    q = unpack_weights(lin.packed, lin.bits, axis=-2)
    acc = x.to(torch.float32) @ q.to(torch.float32)
    return (acc * lin.scale).to(out_dtype)


@register_backend("bit_serial")
def _bit_serial(plan, lin: PackedLinear, x: torch.Tensor, out_dtype):
    """Walks ``radix``-bit digits of the two's-complement code as the FPGA
    engine retires them, the top digit carrying negative weight."""
    bits, radix = lin.bits, plan.radix
    if bits % radix != 0:
        raise ValueError(f"radix {radix} must divide bits {bits}")
    q = unpack_weights(lin.packed, bits, axis=-2)
    u = q.to(torch.int32) & ((1 << bits) - 1)
    n_digits = bits // radix
    xf = x.to(torch.float32)
    acc = None
    for d in range(n_digits):
        digit = (u >> (d * radix)) & ((1 << radix) - 1)
        weight = float(1 << (d * radix))
        if d == n_digits - 1:
            digit = digit - (((digit >> (radix - 1)) & 1) << radix)
        partial = xf @ digit.to(torch.float32)
        acc = weight * partial if acc is None else acc + weight * partial
    return (acc * lin.scale).to(out_dtype)


@register_backend("cuda")
def _cuda(plan, lin: PackedLinear, x: torch.Tensor, out_dtype):
    from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv

    return bitplane_gemv(lin.packed, lin.scale, x, bits=lin.bits,
                         radix=plan.radix, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# grouped (stacked expert) forms
# ---------------------------------------------------------------------------


def _grouped_plain(product, lin: PackedLinear, x, offsets, max_rows,
                   out_dtype):
    """Each expert's rows gathered into ``max_rows`` slots, one float32
    ``product(slots_e, packed_e)`` per expert, scaled and put back: no
    host read, so it runs inside a captured graph."""
    idx, valid = expert_slots(offsets, max_rows)
    xs = gather_slots(x.to(torch.float32), idx, valid)
    acc = torch.stack([product(xs[e], lin.packed[e])
                       for e in range(lin.packed.shape[0])])
    y = (acc * lin.scale).to(out_dtype)
    return scatter_slots(y, idx, valid, x.shape[0])


@register_grouped_backend("reference")
def _reference_grouped(plan, lin, x, offsets, max_rows, out_dtype):
    """``reference`` per expert: the JAX package's ``_reference`` on its
    stacked weights, ``matmul(x, unpack(W)) * scale`` in float32."""
    def product(xe, packed):
        return xe @ unpack_weights(packed, lin.bits, axis=-2).to(
            torch.float32)
    return _grouped_plain(product, lin, x, offsets, max_rows, out_dtype)


@register_grouped_backend("bit_serial")
def _bit_serial_grouped(plan, lin, x, offsets, max_rows, out_dtype):
    def product(xe, packed):
        one = PackedLinear(packed, torch.ones_like(lin.scale[0]), None,
                           lin.bits, lin.in_features, lin.out_features)
        return _bit_serial(plan, one, xe, torch.float32)
    return _grouped_plain(product, lin, x, offsets, max_rows, out_dtype)


@register_grouped_backend("cuda")
def _cuda_grouped(plan, lin, x, offsets, max_rows, out_dtype):
    from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv_grouped

    return bitplane_gemv_grouped(lin.packed, lin.scale, x, offsets,
                                 max_rows=max_rows, bits=lin.bits,
                                 radix=plan.radix, out_dtype=out_dtype)
