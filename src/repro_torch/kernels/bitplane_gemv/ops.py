"""Public wrapper of the bit-plane GEMV.

Flattens ``(..., K)`` activations to ``(M, K)`` and dispatches by the
tensor's device (``bitplane_gemv_grouped``, the stacked-expert form, too):
the CUDA kernel for CUDA tensors, the plain version (``ref.py``) for CPU
tensors, and an error for anything else.  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitplane_gemv.kernel import (
    bitplane_gemv_cuda,
    bitplane_gemv_grouped_cuda,
)
from repro_torch.kernels.bitplane_gemv.ref import (
    bitplane_gemv_grouped_ref,
    bitplane_gemv_ref,
)


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
    if x.device.type == "cpu":
        y = bitplane_gemv_ref(packed, scale, x2, bits=bits, radix=radix,
                              out_dtype=out_dtype)
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
    if x.device.type == "cpu":
        return bitplane_gemv_grouped_ref(packed, scale, x, offsets,
                                         max_rows=max_rows, bits=bits,
                                         radix=radix, out_dtype=out_dtype)
    return bitplane_gemv_grouped_cuda(packed, scale, x.contiguous(), offsets,
                                      max_rows=max_rows, bits=bits,
                                      radix=radix, out_dtype=out_dtype)
