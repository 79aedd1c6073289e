"""Public wrapper of the SSD-scan kernel.

Dispatches by the tensors' device: the CUDA kernel for CUDA tensors, the
plain recurrence (``ref.py``) for CPU tensors, empty outputs for ``meta``
tensors inside the op counter, and an error for anything else.  There is
no fallback from the kernel to the plain version.  Each call opens
``op_cost.priced`` first (``bitplane_gemv/ops.py`` says why), at the
chunk the kernels run.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd_scan.kernel import kernel_chunk, ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.roofline import kernel_costs, op_cost


def ssd_scan(xdt: torch.Tensor, la: torch.Tensor, b_in: torch.Tensor,
             c_in: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y, h_final = SSD(xdt, exp(la), B, C), both float32.

    xdt: ``(B, S, H, P)`` dt-premultiplied head inputs; la: ``(B, S, H)``
    log decay; b_in / c_in: ``(B, S, N)`` state projections.  ``chunk`` is
    cut to S, as the JAX kernel does, and must divide S.
    """
    chunk = min(chunk, xdt.shape[1])
    with op_cost.priced("ssd_scan", lambda: (
            None, *kernel_costs.ssd_scan_call(
                xdt, b_in, kernel_chunk(chunk, xdt.shape[1])))):
        if xdt.device.type == "cpu":
            return ssd_scan_ref(xdt, la, b_in, c_in, chunk)
        if op_cost.dry(xdt):
            b, s, h, p = xdt.shape
            return (op_cost.meta_output((b, s, h, p), torch.float32),
                    op_cost.meta_output((b, h, p, b_in.shape[-1]),
                                        torch.float32))
        return ssd_scan_cuda(_aligned(xdt), _aligned(la.float()),
                             _aligned(b_in), _aligned(c_in), chunk=chunk)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy where a view is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
