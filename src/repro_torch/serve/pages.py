"""Paged KV cache: fixed-size pages, per-request block tables, free-list
allocation.

* :class:`KVPages` — the device-side pool.  Storage is
  ``(L, P, page_size, Hkv, Dh)`` per K and V: every layer sees the same
  physical page ids, so one ``(B, n_blocks)`` block table per request
  addresses all layers.  With ``kv_bits=8`` the pools are int8 and
  per-(token, head) scales ride along as ``(L, P, page_size, Hkv)`` bf16
  pools.  The model writes into the pools in place.
* :class:`PageAllocator` — host-side free list and block tables:
  capacity-based admission (``can_admit``), page grants during decode
  (``ensure``) and whole-request reclaim (``free_slot``).  Physical page 0
  is the null page: idle lanes and masked prefill positions write there,
  so the model functions never need a dynamic shape.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

NULL_PAGE = 0  # physical page 0 is never allocated; garbage writes land here


class AuditError(AssertionError):
    """An allocator invariant audit failed."""


@dataclasses.dataclass
class KVPages:
    """Device-side paged KV pool for all layers.

    ``k`` / ``v``: ``(L, P, page_size, Hkv, Dh)`` in the cache dtype (int8
    when ``kv_bits=8``); ``k_scale`` / ``v_scale``: ``(L, P, page_size,
    Hkv)`` bf16, or None for a full-precision pool.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    page_size: int
    kv_bits: int

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_pages(cfg: ModelConfig, n_pages: int, page_size: int,
                  dtype=None, kv_bits: int = 0, *,
                  device: DeviceLike = None) -> KVPages:
    """An all-zeros page pool for ``cfg`` on ``device`` (None: the GPU)."""
    device = resolve_device(device)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"paged KV for family {cfg.family!r} is not ported yet")
    if kv_bits not in (0, 8):
        raise ValueError(f"kv_bits must be 0/8, got {kv_bits}")
    dtype = dtype or getattr(torch, cfg.dtype)
    if kv_bits:
        dtype = torch.int8
    dh, hkv, nl = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_layers
    shape = (nl, n_pages, page_size, hkv, dh)
    k = torch.zeros(shape, dtype=dtype, device=device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    ks = vs = None
    if kv_bits:
        sshape = (nl, n_pages, page_size, hkv)
        ks = torch.zeros(sshape, dtype=torch.bfloat16, device=device)
        vs = torch.zeros(sshape, dtype=torch.bfloat16, device=device)
    return KVPages(k, v, ks, vs, page_size, kv_bits)


def pages_for(n_tokens: int, page_size: int) -> int:
    """Physical pages needed to hold ``n_tokens``."""
    return max(0, math.ceil(n_tokens / page_size))


class PageAllocator:
    """Host-side block tables + refcounted free list.

    ``n_slots`` lanes each own a ``(max_blocks,)`` block-table row
    (logical block i -> physical page id; ``NULL_PAGE`` where unmapped) and
    a token count ``pos``.  Pages come from one shared free list, so the
    pool holds ``(n_pages - 1) * page_size`` tokens across all lanes.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_len: int):
        self.page_size = page_size
        self.n_pages = n_pages
        self.n_slots = n_slots
        self.max_blocks = pages_for(max_len, page_size)
        if n_pages < self.max_blocks + 1:
            raise ValueError(
                f"n_pages={n_pages} cannot hold one max_len={max_len} "
                f"request (needs {self.max_blocks} pages + the null page)")
        # page 0 is the null page; everything else starts free (LIFO reuse)
        self.free: List[int] = list(range(n_pages - 1, NULL_PAGE, -1))
        self.block_tables = np.full((n_slots, self.max_blocks), NULL_PAGE,
                                    np.int32)
        self.pos = np.zeros((n_slots,), np.int32)
        self._mapped: List[List[int]] = [[] for _ in range(n_slots)]
        self.refcount = np.zeros((n_pages,), np.int32)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self.free)

    def can_allocate(self, n_pages: int) -> bool:
        return n_pages <= len(self.free)

    def can_admit(self, n_tokens: int) -> bool:
        """Room for a prompt of ``n_tokens`` plus one decode token?"""
        return self.can_allocate(pages_for(n_tokens + 1, self.page_size))

    def alloc_page(self, slot: int) -> Optional[int]:
        """Allocate one private page as ``slot``'s next block."""
        if not self.free:
            return None
        page = self.free.pop()
        self.refcount[page] = 1
        self.block_tables[slot, len(self._mapped[slot])] = page
        self._mapped[slot].append(page)
        return page

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s block table to cover ``n_tokens``; False (and no
        change) when the free list cannot cover it."""
        need = pages_for(n_tokens, self.page_size)
        if need > self.max_blocks:
            raise ValueError(
                f"slot {slot} wants {n_tokens} tokens > max_len capacity")
        have = len(self._mapped[slot])
        if need <= have:
            return True
        if not self.can_allocate(need - have):
            return False
        for _ in range(have, need):
            self.alloc_page(slot)
        return True

    def _release_page(self, page: int) -> None:
        if page == NULL_PAGE:
            raise ValueError("the null page is never freed")
        self.refcount[page] -= 1
        if self.refcount[page] < 0:
            raise AssertionError(f"page {page} refcount went negative")
        if self.refcount[page] == 0:
            self.free.append(page)

    def free_slot(self, slot: int) -> None:
        """Release every page the slot maps (request retired or
        preempted)."""
        for page in reversed(self._mapped[slot]):
            self._release_page(page)
        self._mapped[slot] = []
        self.block_tables[slot, :] = NULL_PAGE
        self.pos[slot] = 0

    def block_row(self, slot: int) -> np.ndarray:
        """The slot's block-table row (a copy)."""
        return self.block_tables[slot].copy()

    def audit(self) -> None:
        """Prove the bookkeeping invariants; raise :class:`AuditError`
        naming the first violation: the null page is never referenced,
        the free list holds unique in-range refcount-0 pages disjoint from
        mapped pages, refcounts equal block-table references, each row is
        its mapped pages then ``NULL_PAGE`` padding, ``pos`` fits the
        mapped capacity, and every page is free or mapped."""
        def fail(msg: str) -> None:
            raise AuditError(f"PageAllocator.audit: {msg}")

        if self.refcount[NULL_PAGE] != 0:
            fail(f"null page has refcount {self.refcount[NULL_PAGE]}")
        free_set = set(self.free)
        if len(free_set) != len(self.free):
            fail("free list holds duplicate pages")
        for p in self.free:
            if not NULL_PAGE < p < self.n_pages:
                fail(f"free list holds out-of-range page {p}")
            if self.refcount[p]:
                fail(f"free page {p} has refcount {self.refcount[p]}")
        counts = np.zeros((self.n_pages,), np.int64)
        mapped_set = set()
        for slot in range(self.n_slots):
            mapped, row = self._mapped[slot], self.block_tables[slot]
            n = len(mapped)
            for blk, page in enumerate(mapped):
                if not NULL_PAGE < page < self.n_pages:
                    fail(f"slot {slot} maps out-of-range page {page}")
                if row[blk] != page:
                    fail(f"slot {slot} block {blk}: table says {row[blk]}, "
                         f"mapped says {page}")
                counts[page] += 1
            mapped_set.update(mapped)
            if row[n:].any():
                fail(f"slot {slot} block table addresses pages past its "
                     f"{n} mapped blocks")
            if not 0 <= self.pos[slot] <= n * self.page_size:
                fail(f"slot {slot} pos {self.pos[slot]} outside mapped "
                     f"capacity {n * self.page_size}")
        bad = np.nonzero(counts != self.refcount)[0]
        if bad.size:
            p = int(bad[0])
            fail(f"page {p} refcount {self.refcount[p]} != "
                 f"{int(counts[p])} block-table references")
        if free_set & mapped_set:
            fail(f"page {min(free_set & mapped_set)} is free and mapped")
        leaked = set(range(1, self.n_pages)) - free_set - mapped_set
        if leaked:
            fail(f"pages leaked (neither free nor mapped): "
                 f"{sorted(leaked)[:8]}")

    def device_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(block_tables, pos)`` as int32 tensors on ``device``."""
        return (torch.from_numpy(self.block_tables).to(device),
                torch.from_numpy(self.pos).to(device))
