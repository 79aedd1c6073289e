"""PyTorch port of the IMAGine serving stack for NVIDIA Hopper.

A package beside the JAX reference (``repro``), mirroring its layout file
for file.  It imports ``torch`` and ``numpy`` only.  Hot operations run
hand-written CUDA kernels (``repro_torch/csrc``) on CUDA tensors; each
kernel keeps a plain PyTorch version (``kernels/*/ref.py``) that runs for
CPU tensors and that the kernels are held against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device on a host without a GPU they raise
(:func:`repro_torch.device.resolve_device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
