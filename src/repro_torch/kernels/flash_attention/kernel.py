"""Launcher of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Takes CUDA tensors only: it checks device, dtype, shape and contiguity,
allocates the output with ``torch.empty``, launches on the current stream
and raises if the launch reports an error.  ``route`` picks one of three
routes, each its own C entry point, by dtype and head dim: up to 256,
``tensor_core`` for bfloat16 (wgmma tiles, P split into bf16 hi + lo) and
``cuda_core`` for float32; above 256, ``wide`` for both, the design that
streams D (``csrc/flash_attention.cu``, ``flash_wide_kernel``).  No route
ever gives way to another or to the plain version.  The tiles are compiled for the head dims of
``HEAD_DIMS``; any other D up to 256 is zero-padded to the next of them
(``_heads``), and a D above 256 runs as it is.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._heads import (
    TILE_HEAD_DIMS as HEAD_DIMS,
    WIDEST_TILE,
    pad_head_dim,
    padded_head_dim,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, d: int) -> str:
    """The design that takes q, k, v of ``dtype`` and head dim ``d``: up to
    the tiles' widest head dim, ``tensor_core`` for bfloat16 and
    ``cuda_core`` for float32 (bf16 operands would round it); above it,
    ``wide`` for both (the streamed design takes any D).  Raises for any
    other dtype and for ``d < 1``."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention_cuda: dtype {dtype}")
    if d < 1:
        raise ValueError(f"flash_attention_cuda: head dim {d}")
    if d > WIDEST_TILE:
        return "wide"
    return "cuda_core" if dtype == torch.float32 else "tensor_core"


@functools.lru_cache(maxsize=None)
def _entry(path: str):
    if path == "tensor_core":
        fn = _build.library().imagine_flash_attention_tc
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
    else:
        fn = getattr(_build.library(), "imagine_flash_attention_wide"
                     if path == "wide" else "imagine_flash_attention")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} is on {t.device},"
                             " not on the query's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} is not "
                             "contiguous")
        if t.dtype != q.dtype:
            raise ValueError("flash_attention_cuda: q, k and v must share a "
                             f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash_attention_cuda: q must be (B, S, Hq, D) and "
                         "k, v (B, S, Hkv, D)")
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match")
    if hq % k.shape[2]:
        raise ValueError(f"flash_attention_cuda: Hq={hq} is not a multiple "
                         f"of Hkv={k.shape[2]}")
    if s == 0 or b == 0:
        raise ValueError("flash_attention_cuda: empty input")
    if window < 0:
        raise ValueError(f"flash_attention_cuda: window {window}")
    path = route(q.dtype, d)
    if path == "tensor_core":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention_cuda: {name} is not "
                                 "16-byte aligned")
    return path


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: int = 0) -> torch.Tensor:
    """Causal (+ window) GQA attention on the card; q ``(B, S, Hq, D)``,
    k/v ``(B, S, Hkv, D)`` -> ``(B, S, Hq, D)`` in q's dtype."""
    _build.refuse_grad("flash_attention_cuda", q, k, v)
    window = int(window)
    path = _check(q, k, v, window)
    b, s, hq, d = q.shape
    dp = d if d > WIDEST_TILE else padded_head_dim(d, "flash_attention_cuda")
    q, k, v = (pad_head_dim(t, dp) for t in (q, k, v))
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            hq, k.shape[2], dp, window, d ** -0.5]
    if path != "tensor_core":
        args.append(_DTYPE_CODES[q.dtype])
    err = _entry(path)(*args,
                       torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed ({path}): "
                           f"cudaError {err} (B={b}, S={s}, Hq={hq}, "
                           f"Hkv={k.shape[2]}, D={d})")
    _build.count("flash_attention", path)
    return out if dp == d else out[..., :d].contiguous()
