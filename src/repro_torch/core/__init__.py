from repro_torch.core.bitplane import (
    from_bitplanes,
    pack_weights,
    to_bitplanes,
    unpack_weights,
)
from repro_torch.core.quantize import dequantize, quantize_symmetric

__all__ = [
    "dequantize",
    "from_bitplanes",
    "pack_weights",
    "quantize_symmetric",
    "to_bitplanes",
    "unpack_weights",
]
