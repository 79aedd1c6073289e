"""The paper's contribution: the IMAGine GEMV engine.

Two halves:
  * paper-faithful FPGA model — ``isa``, ``controller``, ``tile_array``,
    ``latency_model`` reproduce the 30-bit ISA, the tile-controller FSM and
    the analytical clock/latency/scaling results of the paper (numpy, on
    the host);
  * the engine on the card — ``quantize``, ``bitplane``, ``gemv_engine``
    implement the same bit-serial GEMV semantics over the hand-written CUDA
    kernels of ``repro_torch.kernels``.
"""

from repro_torch.core.bitplane import (
    from_bitplanes,
    pack_weights,
    to_bitplanes,
    unpack_weights,
)
from repro_torch.core.gemv_engine import (
    QuantizedLinear,
    gemv,
    quantize_linear,
)
from repro_torch.core.quantize import dequantize, quantize_symmetric

__all__ = [
    "QuantizedLinear",
    "dequantize",
    "from_bitplanes",
    "gemv",
    "pack_weights",
    "quantize_linear",
    "quantize_symmetric",
    "to_bitplanes",
    "unpack_weights",
]
