"""Public wrapper of the bit-plane GEMV.

Flattens ``(..., K)`` activations to ``(M, K)`` and dispatches by the
tensor's device (``bitplane_gemv_grouped``, the stacked-expert form, too):
the CUDA kernel for CUDA tensors, the plain version (``ref.py``) for CPU
tensors, an empty output for ``meta`` tensors inside the op counter (a
dry run, ``op_cost.dry``; outside one they go to the CUDA launcher, which
refuses them), and an error for anything else.  There is no fallback from the
kernel to the plain version.  Each call first opens ``op_cost.priced``
with its bytes and operations (``roofline.kernel_costs``) and the route
the card takes, so an active counter prices it alike on every device
(and no counter, no pricing).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitplane_gemv.kernel import (
    bitplane_gemv_cuda,
    bitplane_gemv_grouped_cuda,
)
from repro_torch.kernels._gemv import grouped_route, route
from repro_torch.kernels.bitplane_gemv.ref import (
    bitplane_gemv_grouped_ref,
    bitplane_gemv_ref,
)
from repro_torch.roofline import kernel_costs, op_cost


def bitplane_gemv(
    packed: torch.Tensor,   # (K * bits // 8, N) int8
    scale: torch.Tensor,    # (1, N) float32
    x: torch.Tensor,        # (..., K)
    *,
    bits: int = 8,
    radix: int = 1,
    out_dtype=torch.float32,
) -> torch.Tensor:
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
    n = packed.shape[-1]
    with op_cost.priced("bitplane_gemv", lambda: (
            route(x2.shape[0], x.dtype),
            *kernel_costs.bitplane_gemv_call(packed, x2, bits, out_dtype))):
        if x.device.type == "cpu":
            y = bitplane_gemv_ref(packed, scale, x2, bits=bits, radix=radix,
                                  out_dtype=out_dtype)
        elif op_cost.dry(x):
            y = op_cost.meta_output((x2.shape[0], n), out_dtype)
        else:
            y = bitplane_gemv_cuda(packed, scale, x2.contiguous(), bits=bits,
                                   radix=radix, out_dtype=out_dtype)
    return y.reshape(lead + (n,))


def bitplane_gemv_grouped(
    packed: torch.Tensor,   # (E, K * bits // 8, N) int8
    scale: torch.Tensor,    # (E, 1, N) float32
    x: torch.Tensor,        # (R, K), rows sorted by expert
    offsets: torch.Tensor,  # (E + 1,) int32, on x's device
    *,
    max_rows: int,
    bits: int = 8,
    radix: int = 1,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """``y[offsets[e]:offsets[e+1]] = (x[...] @ unpack(packed[e])) *
    scale[e]``; ``max_rows`` bounds any expert's rows (it picks the card's
    route and sizes its launch).  Rows past ``offsets[E]`` are undefined."""
    with op_cost.priced("bitplane_gemv", lambda: (
            grouped_route(max_rows, x.dtype),
            *kernel_costs.bitplane_gemv_grouped_call(packed, x, max_rows,
                                                     bits, out_dtype))):
        if x.device.type == "cpu":
            return bitplane_gemv_grouped_ref(packed, scale, x, offsets,
                                             max_rows=max_rows, bits=bits,
                                             radix=radix, out_dtype=out_dtype)
        if op_cost.dry(x):
            return op_cost.meta_output((x.shape[0], packed.shape[-1]),
                                       out_dtype)
        return bitplane_gemv_grouped_cuda(packed, scale, x.contiguous(),
                                          offsets, max_rows=max_rows,
                                          bits=bits, radix=radix,
                                          out_dtype=out_dtype)
