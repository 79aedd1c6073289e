"""Launcher of the CUDA int8 bit-parallel GEMV (``csrc/int8_matvec.cu``).

Takes CUDA tensors only: it checks device, dtype, shape and contiguity,
allocates the output with ``torch.empty``, launches on the current stream
and raises if the launch reports an error.  It never falls back to the
plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library().imagine_int8_matvec
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, scale, x, out_dtype):
    for name, t in (("q", q), ("scale", scale), ("x", x)):
        if t.device.type != "cuda":
            raise ValueError(f"int8_matvec_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"int8_matvec_cuda: {name} is not contiguous")
    if q.device != x.device or scale.device != x.device:
        raise ValueError("int8_matvec_cuda: tensors on different devices")
    if q.dtype != torch.int8 or q.ndim != 2:
        raise ValueError("int8_matvec_cuda: q must be 2-D int8, got "
                         f"{q.dtype} {tuple(q.shape)}")
    if x.ndim != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError("int8_matvec_cuda: x must be 2-D float32/bfloat16, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matvec_cuda: out_dtype {out_dtype}")
    if q.shape[0] != x.shape[1]:
        raise ValueError(f"int8_matvec_cuda: q K {q.shape[0]} != x K "
                         f"{x.shape[1]}")
    if scale.dtype != torch.float32 or scale.numel() != q.shape[1]:
        raise ValueError("int8_matvec_cuda: scale must be float32 (1, N)")
    if x.shape[0] == 0:
        raise ValueError("int8_matvec_cuda: x has no rows")


def int8_matvec_cuda(q: torch.Tensor, scale: torch.Tensor, x: torch.Tensor,
                     *, out_dtype=torch.float32) -> torch.Tensor:
    """``(x @ q) * scale`` on the card; q is ``(K, N)`` int8, x ``(M, K)``."""
    _check(q, scale, x, out_dtype)
    m, k = x.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = _entry()(q.data_ptr(), scale.data_ptr(), x.data_ptr(),
                   out.data_ptr(), m, k, n, _DTYPE_CODES[x.dtype],
                   _DTYPE_CODES[out_dtype],
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8_matvec launch failed: cudaError {err} "
                           f"(M={m}, K={k}, N={n})")
    _build.LAUNCHES["int8_matvec"] += 1
    return out
