"""Launcher of the CUDA bit-plane GEMV (``csrc/bitplane_gemv.cu``).

Takes CUDA tensors only: it checks device, dtype, shape and contiguity,
allocates the output (and the split-K partial sums) with ``torch.empty``,
launches on the current stream and raises if the launch reports an error.
``_gemv.route`` picks one of three designs by M and the type of x, each its
own C entry point; the decode route's K split is ``_gemv.decode_splits``.
No route ever gives way to another or to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._gemv import (
    decode_splits,
    route,
    sm_count,
    tc_partial,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(_build.library(), f"imagine_bitplane_gemv_{name}")
    n_ptr, n_int = {"tc": (5, 6), "decode": (4, 8), "rows": (4, 7)}[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(packed, scale, x, bits, radix, out_dtype):
    for name, t in (("packed", packed), ("scale", scale), ("x", x)):
        if t.device.type != "cuda":
            raise ValueError(f"bitplane_gemv_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"bitplane_gemv_cuda: {name} is not contiguous")
    if packed.device != x.device or scale.device != x.device:
        raise ValueError("bitplane_gemv_cuda: tensors on different devices")
    if bits not in (2, 4, 8) or radix not in (1, 2, 4, 8) or bits % radix:
        raise ValueError(f"bitplane_gemv_cuda: bits={bits} radix={radix}")
    if packed.dtype != torch.int8 or packed.ndim != 2:
        raise ValueError("bitplane_gemv_cuda: packed must be 2-D int8, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if x.ndim != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError("bitplane_gemv_cuda: x must be 2-D float32/bfloat16,"
                         f" got {x.dtype} {tuple(x.shape)}")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"bitplane_gemv_cuda: out_dtype {out_dtype}")
    kp, n = packed.shape
    if kp * (8 // bits) != x.shape[1]:
        raise ValueError(f"bitplane_gemv_cuda: packed K {kp}*{8 // bits} != "
                         f"x K {x.shape[1]}")
    if scale.dtype != torch.float32 or scale.numel() != n:
        raise ValueError("bitplane_gemv_cuda: scale must be float32 (1, N)")
    if x.shape[0] == 0:
        raise ValueError("bitplane_gemv_cuda: x has no rows")


def bitplane_gemv_cuda(packed: torch.Tensor, scale: torch.Tensor,
                       x: torch.Tensor, *, bits: int, radix: int,
                       out_dtype=torch.float32) -> torch.Tensor:
    """``(x @ unpack(packed)) * scale`` on the card; x is ``(M, K)``."""
    _check(packed, scale, x, bits, radix, out_dtype)
    m, k = x.shape
    n = packed.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    path = route(m, x.dtype)
    ptrs = (packed.data_ptr(), scale.data_ptr(), x.data_ptr(),
            out.data_ptr())
    if path == "tensor_core":
        splits, partial = tc_partial(m, n, k, x.device)
        err = _entry("tc")(*ptrs, None if partial is None
                           else partial.data_ptr(), m, k, n, bits, splits,
                           _DTYPE_CODES[out_dtype], _stream(x))
    elif path == "decode":
        err = _entry(path)(*ptrs, m, k, n, bits, radix,
                           decode_splits(k, n, sm_count(x.device)),
                           _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
                           _stream(x))
    else:
        err = _entry(path)(*ptrs, m, k, n, bits, radix,
                           _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
                           _stream(x))
    if err:
        raise RuntimeError(f"bitplane_gemv launch failed ({path}): cudaError "
                           f"{err} (M={m}, K={k}, N={n}, bits={bits}, "
                           f"radix={radix})")
    _build.count("bitplane_gemv", path)
    return out
