"""What the two GEMV launchers share (``bitplane_gemv`` and ``int8_matvec``).

``route`` picks one of three CUDA designs by M and the type of x; at 8 bits
the tensor-core tile of ``csrc/tc_gemm.cuh`` is both kernels' own.
``tc_splits`` is the K split of that tile for outputs too small to fill the
card; ``tc::launch`` in ``tc_gemm.cuh`` refuses a split that holds no K.
``TC_TILE`` is that header's ``BM``, ``BN`` and ``BK``.  ``decode_grid`` is
the balanced schedule of both GEMVs' dense decode route (``dec::launch`` in
``csrc/gemv_decode.cuh``, the int8 codes taken as 8-bit packed rows): the
launch's (column tile of ``DECODE_COLS``, K step of ``DECODE_K_STEP``)
units, tile-major, cut into ``grid`` contiguous pieces that differ by at
most one unit, one a block (``decode_pieces`` lists them as the kernel
walks them); ``decode_launch_grid`` adds the card's multiprocessors and
the kernel's occupancy (``decode_occupancy``), and ``decode_scratch`` the
buffer of the tiles that pieces share.  ``grouped_route`` and
``grouped_decode_splits`` are the bit-plane GEMV's expert-grouped launch's
choices, made from the static bound on an expert's rows, never from the
routing; its decode
route keeps the cluster design (a cluster of ``splits`` blocks a column
tile), since a partition made on the host cannot balance rows known only
on the device.  The grouped launch's plain versions put each expert's
rows into ``max_rows`` slots (``expert_slots``, ``gather_slots``,
``scatter_slots``) so that they read nothing back from the device either.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

DECODE_ROWS = 8              # M at or below which the decode design runs
TC_TILE = (128, 256, 64)     # rows, columns and K step of the tensor-core tile
DECODE_COLS = 128            # weight columns of a decode tile
DECODE_K_STEP = 16           # K of a decode block's mma.sync step
DECODE_MAX_SPLITS = 8        # blocks of a grouped cluster (portable limit)
DECODE_MAX_GRID = 512        # blocks of a dense decode launch (dec::MAX_GRID)
DECODE_MIN_PIECE = 16384     # code bytes a dense decode block takes at least
# 4-byte words of a dense decode launch's scratch (dec::SCRATCH_WORDS): two
# float32 slots of DECODE_ROWS x DECODE_COLS sums and a counter a block
DECODE_SCRATCH_WORDS = (2 * DECODE_ROWS * DECODE_COLS + 1) * DECODE_MAX_GRID


def route(m: int, x_dtype: torch.dtype) -> str:
    """The design that takes an ``(m, K)`` x: ``decode`` (bytes-bound, M <=
    8), ``tensor_core`` (bfloat16 x at larger M) or ``rows`` (float32 x at
    larger M, on the CUDA cores: bf16 would round x)."""
    if m <= DECODE_ROWS:
        return "decode"
    return "tensor_core" if x_dtype == torch.bfloat16 else "rows"


def grouped_route(max_rows: int, x_dtype: torch.dtype) -> str:
    """The design of a grouped launch whose experts get at most
    ``max_rows`` rows each (a bound fixed by the shapes, so the launch can
    be captured in a graph): ``route``'s choice at M = ``max_rows``, under
    the ``grouped_`` names."""
    return "grouped_" + route(max_rows, x_dtype)


def grouped_decode_splits(k: int, n: int, experts: int, sms: int) -> int:
    """K splits of the grouped decode route (one cluster of at most
    ``DECODE_MAX_SPLITS`` blocks a column tile of an expert): enough that
    the column tiles of every expert that can receive a row (``experts``:
    at most the experts, and at most the rows) times the splits give a
    block per multiprocessor, rounded so that every split holds some K."""
    tiles = math.ceil(n / DECODE_COLS) * max(1, experts)
    k_steps = math.ceil(k / DECODE_K_STEP)
    want = max(1, min(DECODE_MAX_SPLITS, math.ceil(sms / tiles), k_steps))
    per = math.ceil(k_steps / want)
    return math.ceil(k_steps / per)


def tc_splits(m: int, n: int, k: int, sms: int) -> int:
    """K splits of the tensor-core route (one block per multiprocessor):
    one while the output tiles fill the ``sms`` multiprocessors, else as
    many as fit in one wave, rounded so that every split holds some K."""
    bm, bn, bk = TC_TILE
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    k_steps = math.ceil(k / bk)
    if tiles >= sms:
        return 1
    want = max(1, min(sms // tiles, k_steps))
    per = math.ceil(k_steps / want)
    return math.ceil(k_steps / per)


def decode_units(k: int, n: int) -> int:
    """(column tile, K step) units of a dense decode launch."""
    return math.ceil(n / DECODE_COLS) * math.ceil(k / DECODE_K_STEP)


def decode_grid(k: int, n: int, bits: int, sms: int, occupancy: int) -> int:
    """Blocks of a dense decode launch.  At most the blocks the card holds
    at once (``sms`` multiprocessors x ``occupancy``, the kernel's resident
    blocks an SM, and ``DECODE_MAX_GRID``), and fewer where a piece would
    then hold under ``DECODE_MIN_PIECE`` bytes of codes (a short launch,
    whose pieces' float32 sums would cost more than their codes).  Of that
    cap, the largest multiple of the column tiles when it keeps at least
    5/6 of the cap busy: every piece then lies inside one tile, and no
    block stops mid-piece to hand on a tile's sum (mistral-large-123b's
    w_gate / w_up at 224 of 264, starcoder2-15b's wq / wo and w_down at 240:
    3-19% faster than the full cap; at 192 of 264 the full cap is faster,
    PERF.md).  A function of the shapes, the bits and the card, never of
    M."""
    unit_bytes = DECODE_COLS * DECODE_K_STEP * bits // 8
    min_units = max(1, DECODE_MIN_PIECE // unit_bytes)
    cap = max(1, min(sms * occupancy, DECODE_MAX_GRID,
                     math.ceil(decode_units(k, n) / min_units)))
    tiles = math.ceil(n / DECODE_COLS)
    aligned = tiles * (cap // tiles)
    return aligned if 6 * aligned >= 5 * cap else cap


def decode_pieces(k: int, n: int, grid: int):
    """The dense decode launch's work as the kernel walks it: per block b,
    its units ``[b U / grid, (b + 1) U / grid)`` cut at tile edges, as
    ``(block, tile, first K step, end K step)`` in unit order.  A tile
    cut into several pieces is summed in this order."""
    k_steps = math.ceil(k / DECODE_K_STEP)
    units = decode_units(k, n)
    out = []
    for b in range(grid):
        u, u1 = b * units // grid, (b + 1) * units // grid
        while u < u1:
            tile, s0 = divmod(u, k_steps)
            s1 = min(k_steps, s0 + u1 - u)
            out.append((b, tile, s0, s1))
            u += s1 - s0
    return out


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, bits: int, x_bf16: bool, one_row: bool) -> int:
    from repro_torch.kernels import _build

    fn = _build.library().imagine_gemv_decode_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(bits, int(x_bf16), 1 if one_row else DECODE_ROWS,
                 ctypes.byref(blocks))
    if err or blocks.value < 1:
        raise RuntimeError(f"decode occupancy query failed: cudaError {err}, "
                           f"{blocks.value} blocks (bits={bits})")
    return blocks.value


def decode_occupancy(device: torch.device, bits: int, m: int,
                     x_dtype: torch.dtype) -> int:
    """Blocks an SM of the CUDA ``device`` holds at once of the dense decode
    kernel that takes an ``(m, K)`` x of ``x_dtype`` (read once from the
    card)."""
    x_bf16 = x_dtype == torch.bfloat16
    return _occupancy(device.index or 0, bits, x_bf16, not x_bf16 and m == 1)


def decode_launch_grid(k: int, n: int, bits: int, m: int,
                       x_dtype: torch.dtype, device: torch.device) -> int:
    """:func:`decode_grid` on the CUDA ``device`` for that kernel."""
    return decode_grid(k, n, bits, sm_count(device),
                       decode_occupancy(device, bits, m, x_dtype))


_SCRATCH = {}   # (device index, stream handle or None) -> scratch


def decode_scratch(device: torch.device) -> torch.Tensor:
    """The scratch of a dense decode launch on the CUDA ``device``: the
    float32 sums of the column tiles that pieces share, then a counter a
    block (``DECODE_SCRATCH_WORDS`` words).  Zeroed once, when first
    needed, and left zero by every launch, so a launch needs no memset.

    Launches that share a buffer must run one at a time, in stream order.
    Each stream's eager launches take a buffer of their own, so launches
    on concurrent streams do not race.  Launches captured into CUDA graphs
    take the device's graph buffer, made with its first eager buffer so
    that a capture after an eager call adds no node: graphs that hold such
    launches are replayed in stream order (a replay on another stream,
    ordered by events, is fine; two replays at once are not).  A capture
    that comes before any eager launch on the device zeroes the graph
    buffer inside that graph."""
    index = device.index or 0
    if torch.cuda.is_current_stream_capturing():
        key = (index, None)
    else:
        key = (index, torch.cuda.current_stream(device).cuda_stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        for k in {key, (index, None)} - _SCRATCH.keys():
            _SCRATCH[k] = torch.zeros(DECODE_SCRATCH_WORDS,
                                      dtype=torch.int32, device=device)
        scratch = _SCRATCH[key]
    return scratch


def expert_slots(offsets: torch.Tensor, max_rows: int):
    """``(idx, valid)``, both ``(E, max_rows)``: the row of expert e's j-th
    slot (0 where empty) and whether the slot holds one of its rows."""
    j = torch.arange(max_rows, device=offsets.device)
    idx = offsets[:-1, None].long() + j
    valid = idx < offsets[1:, None].long()
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def gather_slots(x: torch.Tensor, idx: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` into ``(E, max_rows, K)`` slots, zero where empty."""
    return torch.where(valid[..., None], x[idx],
                       torch.zeros((), dtype=x.dtype, device=x.device))


def scatter_slots(y: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """``(E, max_rows, N)`` slot results back to ``(n_rows, N)`` rows;
    rows no slot holds are zero (empty slots land on a spare row that is
    dropped)."""
    n = y.shape[-1]
    out = torch.zeros((n_rows + 1, n), dtype=y.dtype, device=y.device)
    dst = torch.where(valid, idx, torch.full_like(idx, n_rows))
    out.index_copy_(0, dst.reshape(-1), y.reshape(-1, n))
    return out[:n_rows]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Multiprocessors of the CUDA ``device``."""
    return _sm_count(device.index or 0)


def tc_partial(m: int, n: int, k: int, device: torch.device):
    """``(splits, partial)`` for a tensor-core launch: the float32
    ``(splits, M, N)`` partial sums when K is split, else None."""
    splits = tc_splits(m, n, k, sm_count(device))
    if splits == 1:
        return 1, None
    return splits, torch.empty((splits, m, n), dtype=torch.float32,
                               device=device)
