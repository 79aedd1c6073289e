"""Plain PyTorch version of the SSD-scan kernel: the per-step recurrence
on the kernel's pre-discretised inputs, in float64, as the JAX package's
``kernels/ssd_scan/ref.py`` runs it in numpy::

    h_t = exp(la_t) * h_{t-1} + xdt_t (x) B_t,    y_t = C_t . h_t

It is exact up to float64 rounding, so it is the oracle of the chunked
kernel.  The wrapper runs it for CPU tensors, and the CUDA kernel is held
against it on the card.  Outputs are float32, the kernel's type.
"""

from __future__ import annotations

from typing import Tuple

import torch


def ssd_scan_ref(xdt: torch.Tensor, la: torch.Tensor, b_in: torch.Tensor,
                 c_in: torch.Tensor, chunk: int = 128
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt ``(B, S, H, P)``, la ``(B, S, H)``, b_in / c_in ``(B, S, N)`` ->
    (y ``(B, S, H, P)``, final state ``(B, H, P, N)``), float32.
    ``chunk`` is the kernel's; the recurrence does not depend on it."""
    del chunk
    bsz, s, nh, p = xdt.shape
    n = b_in.shape[-1]
    xdt, la = xdt.double(), la.double()
    b_in, c_in = b_in.double(), c_in.double()
    h = torch.zeros((bsz, nh, p, n), dtype=torch.float64, device=xdt.device)
    ys = []
    for t in range(s):
        decay = torch.exp(la[:, t])                          # (B, H)
        h = h * decay[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xdt[:, t], b_in[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", c_in[:, t], h))
    return torch.stack(ys, 1).float(), h.float()
