from repro_torch.kernels.int8_matvec.ops import int8_matvec

__all__ = ["int8_matvec"]
