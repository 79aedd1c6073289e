from repro_torch.kernels.bitplane_gemv.ops import (
    bitplane_gemv,
    bitplane_gemv_grouped,
)

__all__ = ["bitplane_gemv", "bitplane_gemv_grouped"]
