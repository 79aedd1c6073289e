"""Plain PyTorch version of the bit-plane GEMV kernel.

Walks the same radix-digit decomposition the TPU kernel does: one float32
product per digit plane, weighted by ``2^(d·radix)``, the top digit
carrying the sign.  The wrappers run it for CPU tensors, and the CUDA
kernel is held against it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitplane import unpack_weights


def bitplane_gemv_ref(
    packed: torch.Tensor,   # (K * bits // 8, N) int8
    scale: torch.Tensor,    # (1, N) float32
    x: torch.Tensor,        # (M, K)
    *,
    bits: int = 8,
    radix: int = 1,
    out_dtype=torch.float32,
) -> torch.Tensor:
    if bits % radix != 0:
        raise ValueError(f"radix {radix} must divide bits {bits}")
    q = unpack_weights(packed, bits, axis=0)            # (K, N) int8
    code = q.to(torch.int32) & ((1 << bits) - 1)        # two's-complement code
    n_digits = bits // radix
    digit_mask = (1 << radix) - 1
    xf = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], packed.shape[1]), dtype=torch.float32,
                      device=x.device)
    for d in range(n_digits):
        digit = (code >> (d * radix)) & digit_mask
        if d == n_digits - 1:
            sign = (digit >> (radix - 1)) & 1
            digit = digit - (sign << radix)
        acc = acc + float(1 << (d * radix)) * (xf @ digit.to(torch.float32))
    return (acc * scale).to(out_dtype)
