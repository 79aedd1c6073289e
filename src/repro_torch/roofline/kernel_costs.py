"""Bytes and operations of one call of each hand-written kernel, from its
shapes and dtypes alone.

One function a kernel, each returning ``(bytes, operations)``: the bytes
the call must move (each input read once, each output written once) and
the arithmetic it must do (a multiply-add is two).  ``chip_smoke.py``'s
phase ``time`` divides them by the card's rates for the bound of each row
of ``PERF.md``'s kernel table, and the kernels' wrappers hand them to the
op counter (``roofline.op_cost.priced``) through the ``*_call`` helpers
below, so the table's bounds and the dry run price a call alike.

Where the work depends on data that shapes cannot show, the function
takes it as a parameter: the experts a grouped call touches and its rows,
and the keys (and query-key pairs) a paged call reads.  Phase ``time``
passes what its inputs hold.  The wrappers pass the shapes' upper bound,
since a dry run cannot read routing or lengths and the launchers read
nothing back from the device: every expert, at most ``max_rows`` rows
each; every slot of the block table.  On the card the count of a paged
call is therefore an upper bound for a partly filled table.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Cost = Tuple[int, int]


def bitplane_gemv(m: int, k: int, n: int, bits: int, x_bytes: int,
                  out_bytes: Optional[int] = None) -> Cost:
    """``(M, K) @ unpack(K·bits/8, N) * scale``: the codes, the float32
    scales, x and y."""
    ob = x_bytes if out_bytes is None else out_bytes
    return (k * n * bits // 8 + 4 * n + m * k * x_bytes + m * n * ob,
            2 * m * k * n)


def bitplane_gemv_grouped(rows: int, k: int, n: int, bits: int,
                          experts: int, x_bytes: int = 2,
                          out_bytes: Optional[int] = None) -> Cost:
    """The expert-grouped launch over ``rows`` routed rows: the codes and
    scales of the ``experts`` it touches, the rows in and out."""
    ob = x_bytes if out_bytes is None else out_bytes
    per_expert = k * n * bits // 8 + 4 * n
    return (experts * per_expert + rows * (k * x_bytes + n * ob),
            2 * rows * k * n)


def int8_matvec(m: int, k: int, n: int, x_bytes: int,
                out_bytes: Optional[int] = None) -> Cost:
    """``(M, K) @ (K, N) int8 * scale``."""
    ob = x_bytes if out_bytes is None else out_bytes
    return (k * n + 4 * n + m * k * x_bytes + m * n * ob, 2 * m * k * n)


def _kv_bytes(keys: int, hkv: int, dh: int, kv_bytes: int,
              scaled: bool) -> int:
    out = keys * hkv * dh * kv_bytes * 2
    if scaled:
        out += keys * hkv * 2 * 2          # bf16 K and V scales
    return out


def paged_decode_attention(b: int, hkv: int, g: int, dh: int,
                           n_blocks: int, keys: int, kv_bytes: int,
                           q_bytes: int, scaled: bool) -> Cost:
    """One decode token a lane over ``keys`` cached keys in all (each read
    once), the queries in, float32 outputs, the block table and the
    positions."""
    q_elems = b * hkv * g * dh
    nbytes = (_kv_bytes(keys, hkv, dh, kv_bytes, scaled) + q_elems * q_bytes
              + q_elems * 4 + b * n_blocks * 4 + b * 8)
    return nbytes, 4 * keys * hkv * g * dh


def paged_prefill_attention(b: int, c: int, hkv: int, g: int, dh: int,
                            n_blocks: int, keys: int, pairs: int,
                            kv_bytes: int, q_bytes: int,
                            scaled: bool) -> Cost:
    """A chunk of ``c`` queries a lane over ``keys`` keys in all, with
    ``pairs`` (query, key) pairs a KV head's query group (each head of
    the group counts its own)."""
    q_elems = b * c * hkv * g * dh
    nbytes = (_kv_bytes(keys, hkv, dh, kv_bytes, scaled) + q_elems * q_bytes
              + q_elems * 4 + b * n_blocks * 4 + b * 8)
    return nbytes, 4 * pairs * dh


def causal_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs of one causal sequence of ``s`` tokens, each
    query seeing at most ``window`` keys (0: all before it)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_attention(b: int, s: int, hq: int, hkv: int, d: int,
                    itemsize: int, window: int = 0) -> Cost:
    """Causal (windowed) GQA attention over ``b`` sequences of ``s``: q,
    k, v in, the output out."""
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * itemsize
    return nbytes, 4 * d * causal_pairs(s, window) * b * hq


def ssd_scan(b: int, s: int, h: int, p: int, n: int, chunk: int,
             x_bytes: int, la_bytes: int = 4,
             bc_bytes: Optional[int] = None) -> Cost:
    """The chunked SSD scan at ``chunk``: xdt, the log decays, B and C in,
    float32 y and final states out; per lane and chunk C Bᵀ under the
    diagonal once, and per head the decayed intra product, the inter term
    and the state update."""
    bc = x_bytes if bc_bytes is None else bc_bytes
    nbytes = (b * s * h * p * x_bytes + b * s * h * la_bytes
              + 2 * b * s * n * bc + 4 * (b * s * h * p + b * h * p * n))
    tri = chunk * (chunk + 1) // 2
    nc = s // chunk
    ops = b * nc * (2 * n * tri + h * (tri + 2 * p * tri
                                       + 4 * chunk * n * p))
    return nbytes, ops


# ---------------------------------------------------------------------------
# a wrapper's call, priced from its tensors
# ---------------------------------------------------------------------------


def bitplane_gemv_call(packed: torch.Tensor, x2: torch.Tensor, bits: int,
                       out_dtype) -> Cost:
    m, k = x2.shape
    return bitplane_gemv(m, k, packed.shape[-1], bits, x2.element_size(),
                         out_dtype.itemsize)


def bitplane_gemv_grouped_call(packed: torch.Tensor, x: torch.Tensor,
                               max_rows: int, bits: int, out_dtype) -> Cost:
    """Every expert touched, ``min(R, E · max_rows)`` rows."""
    experts = packed.shape[0]
    rows = min(x.shape[0], experts * max_rows)
    return bitplane_gemv_grouped(rows, x.shape[1], packed.shape[-1], bits,
                                 experts, x.element_size(),
                                 out_dtype.itemsize)


def int8_matvec_call(q: torch.Tensor, x2: torch.Tensor, out_dtype) -> Cost:
    m, k = x2.shape
    return int8_matvec(m, k, q.shape[-1], x2.element_size(),
                       out_dtype.itemsize)


def paged_decode_call(q: torch.Tensor, k_pages: torch.Tensor,
                      block_tables: torch.Tensor,
                      k_scale: Optional[torch.Tensor]) -> Cost:
    """``q`` ``(B, 1, Hq, Dh)``; every slot of the block table read."""
    b, _, hq, dh = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    n_blocks = block_tables.shape[1]
    return paged_decode_attention(b, hkv, hq // hkv, dh, n_blocks,
                                  b * n_blocks * page,
                                  k_pages.element_size(), q.element_size(),
                                  k_scale is not None)


def paged_prefill_call(q: torch.Tensor, k_pages: torch.Tensor,
                       block_tables: torch.Tensor,
                       k_scale: Optional[torch.Tensor]) -> Cost:
    """``q`` ``(B, C, Hq, Dh)``; every slot of the block table read, by
    every query of the chunk."""
    b, c, hq, dh = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    n_blocks = block_tables.shape[1]
    keys = b * n_blocks * page
    return paged_prefill_attention(b, c, hkv, hq // hkv, dh, n_blocks,
                                   keys, c * keys * hq, k_pages.element_size(),
                                   q.element_size(), k_scale is not None)


def flash_attention_call(q: torch.Tensor, k: torch.Tensor,
                         window: int) -> Cost:
    """``q`` ``(B, S, Hq, D)``, ``k`` ``(B, S, Hkv, D)``."""
    b, s, hq, d = q.shape
    return flash_attention(b, s, hq, k.shape[2], d, q.element_size(),
                           window)


def ssd_scan_call(xdt: torch.Tensor, b_in: torch.Tensor,
                  chunk: int) -> Cost:
    """``xdt`` ``(B, S, H, P)``, ``b_in`` ``(B, S, N)``; the log decays
    travel as float32; ``chunk`` is the one the kernels run."""
    b, s, h, p = xdt.shape
    return ssd_scan(b, s, h, p, b_in.shape[-1], chunk, xdt.element_size(),
                    4, b_in.element_size())
