"""Public wrapper of the int8 bit-parallel GEMV.

Keeps the JAX wrapper's contract: a 1-D ``x`` gives a 1-D result, leading
dimensions of ``x`` are flattened to ``(M, K)``, and N and K are ragged
(the kernel masks them; nothing is padded).  Dispatches by the tensor's
device: the CUDA kernel for CUDA tensors, the plain version (``ref.py``)
for CPU tensors, an empty output for ``meta`` tensors inside the op
counter (``op_cost.dry``), and an error for anything else.  There is no
fallback from the kernel to the plain version.  Each call opens
``op_cost.priced`` first (``bitplane_gemv/ops.py`` says why).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.int8_matvec.kernel import int8_matvec_cuda
from repro_torch.kernels._gemv import route
from repro_torch.kernels.int8_matvec.ref import int8_matvec_ref
from repro_torch.roofline import kernel_costs, op_cost


def int8_matvec(
    q: torch.Tensor,        # (K, N) int8
    scale: torch.Tensor,    # (1, N) float32
    x: torch.Tensor,        # (..., K) or (K,)
    *,
    out_dtype=torch.float32,
) -> torch.Tensor:
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
    with op_cost.priced("int8_matvec", lambda: (
            route(x2.shape[0], x.dtype),
            *kernel_costs.int8_matvec_call(q, x2, out_dtype))):
        if x.device.type == "cpu":
            y = int8_matvec_ref(q, scale, x2, out_dtype=out_dtype)
        elif op_cost.dry(x):
            y = op_cost.meta_output((x2.shape[0], q.shape[-1]), out_dtype)
        else:
            y = int8_matvec_cuda(q, scale, x2.contiguous(),
                                 out_dtype=out_dtype)
    y = y.reshape(lead + (q.shape[-1],))
    return y[0] if squeeze else y
