"""Legacy surface of the IMAGine GEMV engine.

The engine's real API lives in :mod:`repro_torch.engine`: ``PackedLinear``,
the backend registry and ``EnginePlan``.  This module keeps the original
entry points as thin shims, as the JAX package does:

  * ``QuantizedLinear`` / ``quantize_linear`` — the old NamedTuple weight
    container (convert with ``repro_torch.engine.as_packed``);
  * ``gemv(..., backend=)`` — one GEMV through a one-off ``EnginePlan``;
    ``auto`` resolves by the activations' device, so a CUDA tensor runs the
    bit-plane kernel and a CPU tensor the ``reference`` backend;
  * ``engine_dense`` — the old model-integration helper.

``gemv_reference`` and ``gemv_bit_serial_reference`` are the named
numerical oracles (the ``reference`` / ``bit_serial`` backends'
definitions).

Both paths compute y = scale * (unpacked_int_W @ x) in float32; with
integer activations every partial sum below 2^24 is exact.

Tensors keep their device.  An array that is not a tensor (numpy, a list)
is placed on ``device``; None means the GPU, and raises on a host without
one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bitplane import pack_weights, unpack_weights
from repro_torch.core.quantize import quantize_symmetric
from repro_torch.device import DeviceLike, resolve_device


class QuantizedLinear(NamedTuple):
    """Weight-stationary quantized linear: y = x @ W (W: in_features x out).

    ``packed``: int8, shape (in_features * bits // 8, out_features) — K-axis
    packed.  ``scale``: float32 (1, out_features).  ``bits``: python int.
    """

    packed: torch.Tensor
    scale: torch.Tensor
    bits: int
    in_features: int
    out_features: int


def _tensor(a, device: DeviceLike, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    return torch.as_tensor(a, dtype=dtype, device=resolve_device(device))


def quantize_linear(w, bits: int = 8, *,
                    device: DeviceLike = None) -> QuantizedLinear:
    """Quantize a float (K, N) weight matrix into engine storage format."""
    w = _tensor(w, device, torch.float32)
    k, n = w.shape
    q, scale = quantize_symmetric(w, bits, axis=0)
    packed = pack_weights(q, bits, axis=0)
    return QuantizedLinear(packed, scale, bits, k, n)


def dequantize_linear(qlin: QuantizedLinear,
                      dtype=torch.float32) -> torch.Tensor:
    q = unpack_weights(qlin.packed, qlin.bits, axis=0)
    return (q.to(torch.float32) * qlin.scale).to(dtype)


# ---------------------------------------------------------------------------
# engine forward
# ---------------------------------------------------------------------------


def gemv(
    qlin: QuantizedLinear,
    x,
    *,
    radix: int = 1,
    backend: str = "auto",
    out_dtype=torch.float32,
    device: DeviceLike = None,
) -> torch.Tensor:
    """y = x @ W for engine weights, through a one-off ``EnginePlan``.

    ``backend`` is a registry name (``reference``, ``bit_serial``,
    ``cuda``) or ``auto``, resolved by ``x``'s device.  New code should
    resolve a plan once (``repro_torch.engine.resolve_plan``) and call
    ``plan.apply``.
    """
    from repro_torch.engine import EnginePlan, as_packed, get_backend
    from repro_torch.engine.backends import resolve_backend_name

    x = _tensor(x, device)
    name = resolve_backend_name(backend, x.device)
    plan = EnginePlan(backend=name, bits=qlin.bits, radix=radix)
    lead = tuple(x.shape[:-1])
    y = get_backend(name)(plan, as_packed(qlin), x.reshape(-1, x.shape[-1]),
                          out_dtype)
    return y.reshape(lead + (y.shape[-1],))


def gemv_reference(qlin: QuantizedLinear, x: torch.Tensor,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Unpack the packed int8 codes and contract in float32."""
    q = unpack_weights(qlin.packed, qlin.bits, axis=0)  # (K, N) int8
    acc = x.to(torch.float32) @ q.to(torch.float32)
    return (acc * qlin.scale).to(out_dtype)


def gemv_bit_serial_reference(qlin: QuantizedLinear, x: torch.Tensor,
                              radix: int = 1,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Bit-serial oracle: explicitly walks bit-planes like the FPGA engine.

    y = scale * sum_d  digit_weight_d * (plane_d @ x)

    where planes are ``radix``-bit digits of the two's-complement code, the
    top digit carrying negative weight.  Numerically identical to
    :func:`gemv_reference`.
    """
    bits = qlin.bits
    if bits % radix != 0:
        raise ValueError(f"radix {radix} must divide bits {bits}")
    q = unpack_weights(qlin.packed, qlin.bits, axis=0)
    u = q.to(torch.int32) & ((1 << bits) - 1)  # two's complement code
    n_digits = bits // radix
    xf = x.to(torch.float32)
    acc = torch.zeros(tuple(x.shape[:-1]) + (qlin.out_features,),
                      dtype=torch.float32, device=x.device)
    for d in range(n_digits):
        digit = (u >> (d * radix)) & ((1 << radix) - 1)
        weight = float(1 << (d * radix))
        if d == n_digits - 1:
            # top digit: its MSB is the sign bit of the two's complement code
            sign_bit = (digit >> (radix - 1)) & 1
            digit = digit - (sign_bit << radix)
        acc = acc + weight * (xf @ digit.to(torch.float32))
    return (acc * qlin.scale).to(out_dtype)


# ---------------------------------------------------------------------------
# model-integration helper
# ---------------------------------------------------------------------------


def engine_dense(
    w_or_qlin,
    x: torch.Tensor,
    *,
    engine_bits: int = 0,
    radix: int = 1,
    backend: str = "auto",
    out_dtype=None,
) -> torch.Tensor:
    """With ``engine_bits == 0`` (engine off) ``w_or_qlin`` is a dense
    ``(K, N)`` matrix and this is a plain product; otherwise it is a
    :class:`QuantizedLinear` and the engine runs through :func:`gemv`."""
    if engine_bits == 0:
        w = w_or_qlin
        return (x @ w).to(out_dtype or w.dtype)
    return gemv(w_or_qlin, x, radix=radix, backend=backend,
                out_dtype=out_dtype or x.dtype)
