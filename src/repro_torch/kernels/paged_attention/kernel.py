"""Launchers of the CUDA paged-attention kernels
(``csrc/paged_attention.cu``): decode and chunked prefill.

They take CUDA tensors only: each checks device, dtype, shape and
contiguity, allocates the float32 output with ``torch.empty``, launches on
the current stream and raises if the launch reports an error.  Decode has
one design, split-KV: the lane's keys in splits of ``decode_split_tokens``
keys, one block per split, each leaving float32 (m, l, acc) in scratch
that the launcher allocates, combined in split order by a second kernel of
the same C entry point; the split count follows from the block table's
width (``decode_splits``), so no launch reads the positions back to the
host.  Chunked prefill has two designs, each its own C entry point, picked
by dtype and head dim (``prefill_route``): ``tensor_core`` (mma.sync
tiles) for bfloat16 queries over bfloat16 or int8 pools at head dims up to
256, ``cuda_core`` when the queries or the pools are float32 and for every
head dim above 256; the tensor-core tiles take head dims of
``TC_HEAD_DIMS`` and any other up to 256 zero-padded (``_heads``), the
CUDA-core design any Dh as it is, with fewer query rows a block past 256
(``prefill_block_q``).  No route ever gives way to the other or to the
plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._heads import (
    TILE_HEAD_DIMS as TC_HEAD_DIMS,
    WIDEST_TILE,
    pad_head_dim,
    padded_head_dim,
)

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# query rows (block_q chunk offsets x G heads) a prefill block holds
PREFILL_ROWS = 64
# the decode kernel's head dims, and its K and V tiles: a split's keys x Dh
# at most this many elements each (csrc/paged_attention.cu, DEC_*)
DECODE_MAX_HEAD_DIM = 512
DECODE_TILE_ELEMS = 64 * 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _decode_entry():
    fn = _build.library().imagine_paged_decode_attention
    fn.argtypes = [_P] * 10 + [_I] * 9 + [_F, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def decode_split_tokens(dh: int) -> int:
    """Keys a decode split covers: 64 up to Dh 128, then fewer, so that a
    split's K and V tiles stay at ``DECODE_TILE_ELEMS`` floats; raises for
    Dh above ``DECODE_MAX_HEAD_DIM``."""
    if not 0 < dh <= DECODE_MAX_HEAD_DIM:
        raise ValueError(f"paged_decode_attention_cuda: head dim {dh} not "
                         f"in 1..{DECODE_MAX_HEAD_DIM}")
    width = 32
    while width < dh:
        width *= 2
    return min(64, DECODE_TILE_ELEMS // width)


def decode_splits(n_blocks: int, page: int, dh: int):
    """``(split_tokens, splits)`` of a decode launch over a block table of
    ``n_blocks`` pages of ``page`` keys: every split holds keys of the
    table, and neither depends on the positions."""
    tokens = decode_split_tokens(dh)
    return tokens, -(-(n_blocks * page) // tokens)


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
    ``pool_dtype``: ``cuda_core`` when either is float32, and for every
    head dim above the widest of ``TC_HEAD_DIMS`` (it keeps the TPU
    kernel's casts for bf16 queries and int8 pools too); ``tensor_core``
    for bfloat16 queries over bfloat16 or int8 pools, whose products the
    TPU kernel already takes on bf16 values.  Raises for what neither
    takes: other dtypes, and a tensor-core case whose ``group`` query heads
    exceed a block's ``PREFILL_ROWS`` rows."""
    if q_dtype not in _Q_CODES or pool_dtype not in _POOL_CODES:
        raise ValueError(f"paged_prefill_attention_cuda: q {q_dtype}, "
                         f"pools {pool_dtype}")
    if torch.float32 in (q_dtype, pool_dtype) or dh > WIDEST_TILE:
        return "cuda_core"
    if group > PREFILL_ROWS:
        raise ValueError(f"paged_prefill_attention_cuda: {group} query "
                         f"heads a KV head exceed {PREFILL_ROWS} rows")
    return "tensor_core"


def prefill_block_q(c: int, g: int, dh: int) -> int:
    """Chunk offsets a prefill block holds: ``PREFILL_ROWS`` query rows of
    ``g`` heads each, fewer in proportion above the tiles' widest head dim
    (the CUDA-core design keeps its rows' queries and outputs in shared
    memory, ``2 * rows * Dh`` floats), at least one."""
    rows = PREFILL_ROWS * WIDEST_TILE // max(dh, WIDEST_TILE)
    return max(1, min(c, rows // g))


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
    _build.refuse_grad("paged_decode_attention_cuda", q, k_pages, v_pages,
                       k_scale, v_scale)
    _check("paged_decode_attention_cuda", q, k_pages, v_pages, block_tables,
           [("cur_pos", cur_pos)], k_scale, v_scale)
    b, hkv, g, d = q.shape
    _, page, hkv_p, d_p = k_pages.shape
    if (hkv, d) != (hkv_p, d_p) or block_tables.shape[0] != b:
        raise ValueError("paged_decode_attention_cuda: q (B, Hkv, G, Dh) "
                         f"{tuple(q.shape)} does not match the pool "
                         f"{tuple(k_pages.shape)}")
    n_blocks = block_tables.shape[1]
    split_tokens, splits = decode_splits(n_blocks, page, d)
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    acc = torch.empty((b, hkv, splits, g, d), dtype=torch.float32,
                      device=q.device)
    ml = torch.empty((b, hkv, splits, g, 2), dtype=torch.float32,
                     device=q.device)
    err = _decode_entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), cur_pos.data_ptr(),
        out.data_ptr(), acc.data_ptr(), ml.data_ptr(), b, hkv, g, d, page,
        n_blocks, splits, split_tokens, int(window), d ** -0.5,
        _Q_CODES[q.dtype], _POOL_CODES[k_pages.dtype], _stream(q))
    if err:
        raise RuntimeError(
            f"paged_decode_attention launch failed: cudaError {err}")
    _build.count("paged_decode_attention")
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
    _build.refuse_grad("paged_prefill_attention_cuda", q, k_pages, v_pages,
                       k_scale, v_scale)
    _check("paged_prefill_attention_cuda", q, k_pages, v_pages, block_tables,
           [("pos0", pos0), ("seq_lens", seq_lens)], k_scale, v_scale)
    b, c, hkv, g, d = q.shape
    _, page, hkv_p, d_p = k_pages.shape
    if (hkv, d) != (hkv_p, d_p) or block_tables.shape[0] != b:
        raise ValueError("paged_prefill_attention_cuda: q (B, C, Hkv, G, Dh) "
                         f"{tuple(q.shape)} does not match the pool "
                         f"{tuple(k_pages.shape)}")
    path = prefill_route(q.dtype, k_pages.dtype, d, g)
    dp = d
    if path == "tensor_core":
        # the tiles' head dims: q and both pools zero-padded (a copy of the
        # pools, for head dims outside TC_HEAD_DIMS only)
        dp = padded_head_dim(d, "paged_prefill_attention_cuda")
        q, k_pages, v_pages = (pad_head_dim(t, dp)
                               for t in (q, k_pages, v_pages))
        for tname, t in (("q", q), ("k_pages", k_pages),
                         ("v_pages", v_pages)):
            if t.data_ptr() % 16:
                raise ValueError(f"paged_prefill_attention_cuda: {tname} "
                                 "is not 16-byte aligned")
    block_q = prefill_block_q(c, g, d)
    out = torch.empty((b, c, hkv, g, dp), dtype=torch.float32,
                      device=q.device)
    args = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            pos0.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), b, c, hkv,
            g, dp, page, block_tables.shape[1], block_q, int(window),
            d ** -0.5]
    if path == "cuda_core":
        args.append(_Q_CODES[q.dtype])
    err = _prefill_entry(path)(*args, _POOL_CODES[k_pages.dtype], _stream(q))
    if err:
        raise RuntimeError(f"paged_prefill_attention launch failed ({path}):"
                           f" cudaError {err}")
    _build.count("paged_prefill_attention", path)
    return out if dp == d else out[..., :d].contiguous()
