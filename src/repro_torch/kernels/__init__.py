"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each kernel keeps the JAX package's split: ``kernel.py`` launches the CUDA
kernel (sources in ``repro_torch/csrc``, built by ``_build``), ``ops.py``
is the public wrapper that dispatches by device, and ``ref.py`` is the
plain PyTorch version used for CPU tensors and held against the kernel.
"""
