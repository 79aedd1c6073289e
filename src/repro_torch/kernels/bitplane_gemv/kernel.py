"""Launcher of the CUDA bit-plane GEMV (``csrc/bitplane_gemv.cu``, and
``csrc/bitplane_gemv_grouped.cu`` for stacked experts).

Takes CUDA tensors only: it checks device, dtype, shape and contiguity,
allocates the output (and the split-K partial sums) with ``torch.empty``,
launches on the current stream and raises if the launch reports an error.
``_gemv.route`` picks one of three designs by M and the type of x, each its
own C entry point; the decode route's grid is ``_gemv.decode_launch_grid``
(the balanced schedule), its scratch ``_gemv.decode_scratch`` (one buffer a
stream, so launches that share one stay in stream order), and each of its
launches also counts in ``_build.BALANCED_LAUNCHES``.  No route ever gives
way to another or to the plain version.

``bitplane_gemv_grouped_cuda`` is the expert-grouped launch of the same
three designs over stacked MoE experts: one C entry point, the route
(``_gemv.grouped_route``) and the launch's size taken from ``max_rows``,
the caller's static bound on an expert's rows, and the row ranges read by
the kernel from ``offsets`` on the device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._gemv import (
    decode_launch_grid,
    decode_scratch,
    grouped_decode_splits,
    grouped_route,
    route,
    sm_count,
    tc_partial,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(_build.library(), f"imagine_bitplane_gemv_{name}")
    n_ptr, n_int = {"tc": (5, 6), "decode": (5, 8), "rows": (4, 7),
                    "grouped": (5, 10)}[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(packed, scale, x, bits, radix, out_dtype, stacked=False):
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
    if packed.dtype != torch.int8 or packed.ndim != (3 if stacked else 2):
        raise ValueError("bitplane_gemv_cuda: packed must be int8 "
                         f"{'(E, Kp, N)' if stacked else '(Kp, N)'}, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if x.ndim != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError("bitplane_gemv_cuda: x must be 2-D float32/bfloat16,"
                         f" got {x.dtype} {tuple(x.shape)}")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"bitplane_gemv_cuda: out_dtype {out_dtype}")
    kp, n = packed.shape[-2:]
    if kp * (8 // bits) != x.shape[1]:
        raise ValueError(f"bitplane_gemv_cuda: packed K {kp}*{8 // bits} != "
                         f"x K {x.shape[1]}")
    n_scale = packed.shape[0] * n if stacked else n
    if scale.dtype != torch.float32 or scale.numel() != n_scale:
        raise ValueError("bitplane_gemv_cuda: scale must be float32 "
                         f"{'(E, 1, N)' if stacked else '(1, N)'}")
    if x.shape[0] == 0:
        raise ValueError("bitplane_gemv_cuda: x has no rows")


def bitplane_gemv_cuda(packed: torch.Tensor, scale: torch.Tensor,
                       x: torch.Tensor, *, bits: int, radix: int,
                       out_dtype=torch.float32) -> torch.Tensor:
    """``(x @ unpack(packed)) * scale`` on the card; x is ``(M, K)``.

    At M <= 8 the launch uses the scratch of the current stream
    (``_gemv.decode_scratch``): launches on one stream run in its order,
    launches on concurrent streams each take their own buffer, and CUDA
    graphs that hold such launches must not be replayed at once."""
    _build.refuse_grad("bitplane_gemv_cuda", packed, scale, x)
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
        err = _entry(path)(*ptrs, decode_scratch(x.device).data_ptr(),
                           m, k, n, bits, radix,
                           decode_launch_grid(k, n, bits, m, x.dtype,
                                              x.device),
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
    if path == "decode":
        _build.count_balanced()
    return out


def bitplane_gemv_grouped_cuda(packed: torch.Tensor, scale: torch.Tensor,
                               x: torch.Tensor, offsets: torch.Tensor, *,
                               max_rows: int, bits: int, radix: int,
                               out_dtype=torch.float32) -> torch.Tensor:
    """Stacked experts on the card: ``y[offsets[e]:offsets[e+1]] =
    (x[...] @ unpack(packed[e])) * scale[e]`` for ``packed`` ``(E, Kp,
    N)``, ``scale`` ``(E, 1, N)``, ``x`` ``(R, K)`` sorted by expert and
    ``offsets`` ``(E + 1,)`` int32 on the same card.  ``max_rows``, a bound
    on any expert's rows fixed by the caller's shapes, picks the route and
    sizes the launch; nothing is read back from the card.  Rows past
    ``offsets[E]`` are left unwritten."""
    _build.refuse_grad("bitplane_gemv_grouped_cuda", packed, scale, x)
    _check(packed, scale, x, bits, radix, out_dtype, stacked=True)
    e, _, n = packed.shape
    r, k = x.shape
    if (offsets.device != x.device or offsets.dtype != torch.int32
            or tuple(offsets.shape) != (e + 1,)
            or not offsets.is_contiguous()):
        raise ValueError("bitplane_gemv_grouped_cuda: offsets must be a "
                         f"contiguous ({e + 1},) int32 tensor on {x.device},"
                         f" got {offsets.dtype} {tuple(offsets.shape)} on "
                         f"{offsets.device}")
    if max_rows < 1:
        raise ValueError(f"bitplane_gemv_grouped_cuda: max_rows {max_rows}")
    out = torch.empty((r, n), dtype=out_dtype, device=x.device)
    path = grouped_route(max_rows, x.dtype)
    splits = (grouped_decode_splits(k, n, min(e, r), sm_count(x.device))
              if path == "grouped_decode" else 1)
    code = {"grouped_decode": 0, "grouped_rows": 1,
            "grouped_tensor_core": 2}[path]
    err = _entry("grouped")(packed.data_ptr(), scale.data_ptr(), x.data_ptr(),
                            offsets.data_ptr(), out.data_ptr(), e, max_rows,
                            k, n, bits, radix, splits, code,
                            _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
                            _stream(x))
    if err:
        raise RuntimeError(f"bitplane_gemv grouped launch failed ({path}): "
                           f"cudaError {err} (E={e}, max_rows={max_rows}, "
                           f"K={k}, N={n}, bits={bits}, radix={radix})")
    _build.count("bitplane_gemv", path)
    return out
