from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv

__all__ = ["bitplane_gemv"]
