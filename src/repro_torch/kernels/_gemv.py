"""What the two GEMV launchers share (``bitplane_gemv`` and ``int8_matvec``).

``route`` picks one of three CUDA designs by M and the type of x; at 8 bits
the tensor-core tile of ``csrc/tc_gemm.cuh`` is both kernels' own.
``tc_splits`` is the K split of that tile for outputs too small to fill the
card; ``tc::launch`` in ``tc_gemm.cuh`` refuses a split that holds no K.
``TC_TILE`` is that header's ``BM``, ``BN`` and ``BK``.  ``decode_splits``
is the K split of both GEMVs' decode route (``dec::`` in
``csrc/gemv_decode.cuh``, the int8 codes taken as 8-bit packed rows: a
cluster of ``splits`` blocks per column tile of ``DECODE_COLS``, K in steps
of ``DECODE_K_STEP``).  ``grouped_route`` and ``grouped_decode_splits`` are
the same choices for the bit-plane GEMV's expert-grouped launch, made from
the static bound on an expert's rows, never from the routing; the
grouped launch's plain versions put each expert's rows into ``max_rows``
slots (``expert_slots``, ``gather_slots``, ``scatter_slots``) so that they
read nothing back from the device either.
"""

from __future__ import annotations

import functools
import math

import torch

DECODE_ROWS = 8              # M at or below which the decode design runs
TC_TILE = (128, 256, 64)     # rows, columns and K step of the tensor-core tile
DECODE_COLS = 128            # weight columns of a decode block
DECODE_K_STEP = 16           # K of a decode block's mma.sync step
DECODE_MAX_SPLITS = 8        # blocks of a cluster (the portable limit)


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
    """K splits of the grouped decode route: :func:`decode_splits` with
    the column tiles of every expert that can receive a row (``experts``:
    at most the experts, and at most the rows)."""
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


def decode_splits(k: int, n: int, sms: int) -> int:
    """K splits of the GEMVs' decode route: enough that the column tiles
    times the splits give a block per multiprocessor, at most
    ``DECODE_MAX_SPLITS`` (one cluster), rounded so that every split holds
    some K.  Depends on the shapes and the card only (not on M, which the
    kernel takes up to ``DECODE_ROWS`` at one cost).  Two blocks per
    multiprocessor, more than stay resident at once, gave w_gate/w_up a
    second wave (PERF.md, ``decode_splits_sweep.py``)."""
    tiles = math.ceil(n / DECODE_COLS)
    k_steps = math.ceil(k / DECODE_K_STEP)
    want = max(1, min(DECODE_MAX_SPLITS, math.ceil(sms / tiles), k_steps))
    per = math.ceil(k_steps / want)
    return math.ceil(k_steps / per)


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
