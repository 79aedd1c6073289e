"""Launcher of the CUDA SSD scan (``csrc/ssd_scan.cu``).

Takes CUDA tensors only: it checks device, dtype, shape, contiguity and
16-byte alignment, allocates the float32 outputs and the scratch with
``torch.empty``, launches on the current stream and raises if the launch
reports an error.  It never falls back to the plain version, and it reads
nothing back from the card: every grid follows from the shapes.

One call runs three CUDA kernels in order and counts one launch of
``ssd_scan``: ``ssd_chunk_state_kernel`` (each chunk's own state update,
grid (head, chunk, lane)), ``ssd_state_scan_kernel`` (the states entering
the chunks, in chunk order), then the outputs y, one head a block:
``ssd_output_wgmma_kernel`` for bfloat16 inputs (wgmma), else
``ssd_output_kernel`` (mma.sync), both on the grid (row half x head,
chunk, lane).  Scratch: the chunks' own state updates
``(B, nc, H, P, N)`` and total log decays ``(B, nc, H)``, float32, and the
states entering the chunks as bf16 hi and lo ``(B, nc, H, 2, P, N)``.
Chunks longer than ``MAX_CHUNK`` steps are cut into chunks of
``MAX_CHUNK`` (the chunked algorithm computes the same function at any
chunk length).
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
MAX_CHUNK = 256      # steps of a chunk the kernels take


def kernel_chunk(chunk: int, s: int) -> int:
    """The chunk length the kernels run: ``chunk`` cut to S and to
    ``MAX_CHUNK``."""
    return min(chunk, s, MAX_CHUNK)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library().imagine_ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
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
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_scan_cuda: {name} is not 16-byte aligned")
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
    kc = kernel_chunk(chunk, s)
    nc = -(-s // kc)
    dev = xdt.device
    y = torch.empty((bsz, s, nh, p), dtype=torch.float32, device=dev)
    h = torch.empty((bsz, nh, p, n), dtype=torch.float32, device=dev)
    states = torch.empty((bsz, nc, nh, p, n), dtype=torch.float32,
                         device=dev)
    enter = torch.empty((bsz, nc, nh, 2, p, n), dtype=torch.bfloat16,
                        device=dev)
    totals = torch.empty((bsz, nc, nh), dtype=torch.float32, device=dev)
    err = _entry()(xdt.data_ptr(), la.data_ptr(), b_in.data_ptr(),
                   c_in.data_ptr(), y.data_ptr(), h.data_ptr(),
                   states.data_ptr(), enter.data_ptr(), totals.data_ptr(),
                   bsz, s, nh, p, n, kc, _DTYPE_CODES[xdt.dtype],
                   torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err} "
                           f"(B={bsz}, S={s}, H={nh}, P={p}, N={n}, "
                           f"chunk={kc})")
    _build.LAUNCHES["ssd_scan"] += 1
    return y, h
