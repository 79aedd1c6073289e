"""Launcher of the CUDA SSD-scan kernel (``csrc/ssd_scan.cu``).

Takes CUDA tensors only: it checks device, dtype, shape and contiguity,
allocates the float32 outputs with ``torch.empty``, launches on the current
stream and raises if the launch reports an error.  It never falls back to
the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
STATE_DIMS = (64, 128)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library().imagine_ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(xdt, la, b_in, c_in, chunk):
    for name, t in (("xdt", xdt), ("la", la), ("b_in", b_in),
                    ("c_in", c_in)):
        if t.device.type != "cuda" or t.device != xdt.device:
            raise ValueError(f"ssd_scan_cuda: {name} is on {t.device}, not "
                             "on xdt's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan_cuda: {name} is not contiguous")
    if xdt.dtype not in _DTYPE_CODES or b_in.dtype != xdt.dtype or (
            c_in.dtype != xdt.dtype):
        raise ValueError("ssd_scan_cuda: xdt, b_in and c_in must share a "
                         "float32 or bfloat16 dtype, got "
                         f"{xdt.dtype}, {b_in.dtype}, {c_in.dtype}")
    if la.dtype != torch.float32:
        raise ValueError(f"ssd_scan_cuda: la must be float32, got {la.dtype}")
    if xdt.ndim != 4:
        raise ValueError("ssd_scan_cuda: xdt must be (B, S, H, P)")
    bsz, s, nh, p = xdt.shape
    if la.shape != (bsz, s, nh):
        raise ValueError(f"ssd_scan_cuda: la {tuple(la.shape)} is not "
                         f"{(bsz, s, nh)}")
    if b_in.ndim != 3 or b_in.shape[:2] != (bsz, s) or (
            c_in.shape != b_in.shape):
        raise ValueError("ssd_scan_cuda: b_in and c_in must be (B, S, N)")
    if p != HEAD_DIM or b_in.shape[2] not in STATE_DIMS:
        raise ValueError(f"ssd_scan_cuda: P={p}, N={b_in.shape[2]}; the "
                         f"kernel takes P={HEAD_DIM}, N in {STATE_DIMS}")
    if chunk <= 0 or s == 0 or s % chunk:
        raise ValueError(f"ssd_scan_cuda: S={s} is not a multiple of "
                         f"chunk={chunk}")


def ssd_scan_cuda(xdt: torch.Tensor, la: torch.Tensor, b_in: torch.Tensor,
                  c_in: torch.Tensor, *, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan on the card: (y ``(B, S, H, P)``, final state
    ``(B, H, P, N)``), both float32."""
    _check(xdt, la, b_in, c_in, chunk)
    bsz, s, nh, p = xdt.shape
    n = b_in.shape[2]
    y = torch.empty((bsz, s, nh, p), dtype=torch.float32, device=xdt.device)
    h = torch.empty((bsz, nh, p, n), dtype=torch.float32, device=xdt.device)
    err = _entry()(xdt.data_ptr(), la.data_ptr(), b_in.data_ptr(),
                   c_in.data_ptr(), y.data_ptr(), h.data_ptr(), bsz, s, nh,
                   p, n, chunk, _DTYPE_CODES[xdt.dtype],
                   torch.cuda.current_stream(xdt.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err} "
                           f"(B={bsz}, S={s}, H={nh}, P={p}, N={n}, "
                           f"chunk={chunk})")
    _build.LAUNCHES["ssd_scan"] += 1
    return y, h
