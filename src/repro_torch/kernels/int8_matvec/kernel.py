"""Launcher of the CUDA int8 bit-parallel GEMV (``csrc/int8_matvec.cu``).

Takes CUDA tensors only: it checks device, dtype, shape and contiguity,
allocates the output (and the split-K partial sums) with ``torch.empty``,
launches on the current stream and raises if the launch reports an error.
``_gemv.route`` picks the design, as for the bit-plane GEMV, each its own
C entry point: at 8 bits that GEMV's decode design (``dec::`` of
``csrc/gemv_decode.cuh``, with the K split of ``_gemv.decode_splits``) and
its tensor-core tile are this kernel's too.  No route ever gives way to
another or to the plain version.
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
    fn = getattr(_build.library(), f"imagine_int8_matvec_{name}")
    n_ptr, n_int = {"tc": (5, 5), "decode": (4, 6), "rows": (4, 5)}[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
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
    path = route(m, x.dtype)
    ptrs = (q.data_ptr(), scale.data_ptr(), x.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if path == "tensor_core":
        splits, partial = tc_partial(m, n, k, x.device)
        err = _entry("tc")(*ptrs, None if partial is None
                           else partial.data_ptr(), m, k, n, splits,
                           _DTYPE_CODES[out_dtype], stream)
    elif path == "decode":
        err = _entry(path)(*ptrs, m, k, n,
                           decode_splits(k, n, sm_count(x.device)),
                           _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
                           stream)
    else:
        err = _entry(path)(*ptrs, m, k, n, _DTYPE_CODES[x.dtype],
                           _DTYPE_CODES[out_dtype], stream)
    if err:
        raise RuntimeError(f"int8_matvec launch failed ({path}): cudaError "
                           f"{err} (M={m}, K={k}, N={n})")
    _build.count("int8_matvec", path)
    return out
