"""Launchers of the CUDA paged-attention kernels
(``csrc/paged_attention.cu``): decode and chunked prefill.

They take CUDA tensors only: each checks device, dtype, shape and
contiguity, allocates the float32 output with ``torch.empty``, launches on
the current stream and raises if the launch reports an error.  Chunked
prefill has two designs, each its own C entry point, picked by dtype
(``prefill_route``): ``tensor_core`` (mma.sync tiles) for bfloat16 queries
over bfloat16 or int8 pools, ``cuda_core`` when the queries or the pools
are float32.  No route ever gives way to the other or to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# query rows (block_q chunk offsets x G heads) a prefill block holds
PREFILL_ROWS = 64
# head dims of the prefill's tensor-core route
TC_HEAD_DIMS = (32, 64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _decode_entry():
    fn = _build.library().imagine_paged_decode_attention
    fn.argtypes = [_P] * 8 + [_I] * 7 + [_F, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _prefill_entry(path: str):
    if path == "tensor_core":
        fn = _build.library().imagine_paged_prefill_attention_tc
        fn.argtypes = [_P] * 9 + [_I] * 9 + [_F, _I, _P]
    else:
        fn = _build.library().imagine_paged_prefill_attention
        fn.argtypes = [_P] * 9 + [_I] * 9 + [_F, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def prefill_route(q_dtype: torch.dtype, pool_dtype: torch.dtype, dh: int,
                  group: int) -> str:
    """The chunked-prefill design for bf16 / float32 queries over pools of
    ``pool_dtype``: ``cuda_core`` when either is float32; ``tensor_core``
    for bfloat16 queries over bfloat16 or int8 pools, whose products the
    TPU kernel already takes on bf16 values.  Raises for what neither
    takes: other dtypes, and a tensor-core case whose head dim is not in
    ``TC_HEAD_DIMS`` or whose ``group`` query heads exceed a block's
    ``PREFILL_ROWS`` rows."""
    if q_dtype not in _Q_CODES or pool_dtype not in _POOL_CODES:
        raise ValueError(f"paged_prefill_attention_cuda: q {q_dtype}, "
                         f"pools {pool_dtype}")
    if torch.float32 in (q_dtype, pool_dtype):
        return "cuda_core"
    if dh not in TC_HEAD_DIMS:
        raise ValueError(f"paged_prefill_attention_cuda: head dim {dh} not "
                         f"in {TC_HEAD_DIMS}")
    if group > PREFILL_ROWS:
        raise ValueError(f"paged_prefill_attention_cuda: {group} query "
                         f"heads a KV head exceed {PREFILL_ROWS} rows")
    return "tensor_core"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, q, k_pages, v_pages, block_tables, lane_ints,
           k_scale, v_scale):
    tensors = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("block_tables", block_tables)] + lane_ints
    if k_scale is not None or v_scale is not None:
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for tname, t in tensors:
        if t is None:
            raise ValueError(f"{name}: {tname} is missing")
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, not on the "
                             f"query's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} is not contiguous")
    if q.dtype not in _Q_CODES:
        raise ValueError(f"{name}: q dtype {q.dtype}")
    if k_pages.dtype not in _POOL_CODES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{name}: pool dtypes {k_pages.dtype}/"
                         f"{v_pages.dtype}")
    if k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: pools must be (P, page, Hkv, Dh)")
    quant = k_pages.dtype == torch.int8
    if quant:
        if k_scale is None:
            raise ValueError(f"{name}: int8 pools need k_scale/v_scale")
        for t in (k_scale, v_scale):
            if t.dtype != torch.bfloat16 or t.shape != k_pages.shape[:3]:
                raise ValueError(f"{name}: scales must be bf16 "
                                 f"{tuple(k_pages.shape[:3])}")
    elif k_scale is not None:
        raise ValueError(f"{name}: scales given for {k_pages.dtype} pools")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2:
        raise ValueError(f"{name}: block_tables must be 2-D int32")
    b = block_tables.shape[0]
    for tname, t in lane_ints:
        if t.dtype != torch.int32 or t.shape != (b,):
            raise ValueError(f"{name}: {tname} must be int32 ({b},)")
    return quant


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def paged_decode_attention_cuda(
    q: torch.Tensor,              # (B, Hkv, G, Dh)
    k_pages: torch.Tensor,        # (P, page, Hkv, Dh)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (B, n_blocks) int32
    cur_pos: torch.Tensor,        # (B,) int32
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,   # (P, page, Hkv) bf16
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused paged decode attention; ``(B, Hkv, G, Dh)`` float32."""
    _check("paged_decode_attention_cuda", q, k_pages, v_pages, block_tables,
           [("cur_pos", cur_pos)], k_scale, v_scale)
    b, hkv, g, d = q.shape
    _, page, hkv_p, d_p = k_pages.shape
    if (hkv, d) != (hkv_p, d_p) or block_tables.shape[0] != b:
        raise ValueError("paged_decode_attention_cuda: q (B, Hkv, G, Dh) "
                         f"{tuple(q.shape)} does not match the pool "
                         f"{tuple(k_pages.shape)}")
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    err = _decode_entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), cur_pos.data_ptr(),
        out.data_ptr(), b, hkv, g, d, page, block_tables.shape[1],
        int(window), d ** -0.5, _Q_CODES[q.dtype],
        _POOL_CODES[k_pages.dtype], _stream(q))
    if err:
        raise RuntimeError(
            f"paged_decode_attention launch failed: cudaError {err}")
    _build.LAUNCHES["paged_decode_attention"] += 1
    return out


def paged_prefill_attention_cuda(
    q: torch.Tensor,              # (B, C, Hkv, G, Dh)
    k_pages: torch.Tensor,        # (P, page, Hkv, Dh)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (B, n_blocks) int32
    pos0: torch.Tensor,           # (B,) int32
    seq_lens: torch.Tensor,       # (B,) int32
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused paged chunked-prefill attention; ``(B, C, Hkv, G, Dh)``
    float32.  The chunk's K/V must already be in the pool."""
    _check("paged_prefill_attention_cuda", q, k_pages, v_pages, block_tables,
           [("pos0", pos0), ("seq_lens", seq_lens)], k_scale, v_scale)
    b, c, hkv, g, d = q.shape
    _, page, hkv_p, d_p = k_pages.shape
    if (hkv, d) != (hkv_p, d_p) or block_tables.shape[0] != b:
        raise ValueError("paged_prefill_attention_cuda: q (B, C, Hkv, G, Dh) "
                         f"{tuple(q.shape)} does not match the pool "
                         f"{tuple(k_pages.shape)}")
    path = prefill_route(q.dtype, k_pages.dtype, d, g)
    if path == "tensor_core":
        for tname, t in (("q", q), ("k_pages", k_pages),
                         ("v_pages", v_pages)):
            if t.data_ptr() % 16:
                raise ValueError(f"paged_prefill_attention_cuda: {tname} "
                                 "is not 16-byte aligned")
    block_q = max(1, min(c, PREFILL_ROWS // g))
    out = torch.empty((b, c, hkv, g, d), dtype=torch.float32,
                      device=q.device)
    args = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            pos0.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), b, c, hkv,
            g, d, page, block_tables.shape[1], block_q, int(window),
            d ** -0.5]
    if path == "cuda_core":
        args.append(_Q_CODES[q.dtype])
    err = _prefill_entry(path)(*args, _POOL_CODES[k_pages.dtype], _stream(q))
    if err:
        raise RuntimeError(f"paged_prefill_attention launch failed ({path}):"
                           f" cudaError {err}")
    _build.count("paged_prefill_attention", path)
    return out
