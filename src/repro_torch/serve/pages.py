"""Paged KV cache: fixed-size pages, per-request block tables, free-list
allocation.

* :class:`KVPages` — the device-side pool.  Storage is
  ``(L, P, page_size, Hkv, Dh)`` per K and V: every layer sees the same
  physical page ids, so one ``(B, n_blocks)`` block table per request
  addresses all layers.  With ``kv_bits=8`` the pools are int8 and
  per-(token, head) scales ride along as ``(L, P, page_size, Hkv)`` bf16
  pools.  The model writes into the pools in place.
* :class:`PageAllocator` — host-side free list and block tables:
  capacity checks (``can_allocate``), page grants during decode
  (``ensure``) and whole-request reclaim (``free_slot``).  Physical page 0
  is the null page: idle lanes and masked prefill positions write there,
  so the model functions never need a dynamic shape.  Pages are reference
  counted: one page may back many lanes' block tables (a shared prompt
  prefix), and with a prefix cache attached
  (:mod:`repro_torch.serve.prefix_cache`) a page whose count drops to 0
  stays resident as an evictable cached page instead of returning to the
  free list; ``_take_page`` evicts such pages when the free list runs dry.
  An attached ``ChaosInjector`` fails page grants at its ``page_grant``
  site, and the allocator reports pool occupancy to its telemetry.
* :class:`ShardedPageAllocator` — the allocator of a mesh whose lanes
  and pages are split over its data shards: each shard's lanes take
  pages from the shard's own range of the pool.
* :func:`fork_tail_page` — the copy-on-write step of a mid-page cache
  hit: the donor's partly filled page is copied, in place, into the
  request's own page.
* :func:`scrub_pages` — zero a faulted lane's private pages, in place,
  before they return to the free list.
* :class:`LaneTables` — persistent device buffers of the per-lane inputs
  of the serving steps (block tables, ``pos``, tokens, prefill bounds,
  the active mask), refilled with ``copy_`` before each step so that a
  captured CUDA graph reads them at fixed addresses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import PAGED_FAMILIES, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.telemetry import NULL_TELEMETRY

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
                  device: DeviceLike = None,
                  n_kv_heads: Optional[int] = None) -> KVPages:
    """An all-zeros page pool for ``cfg`` on ``device`` (None: the GPU).
    ``n_kv_heads``: the KV heads the pool holds (default
    ``cfg.n_kv_heads``; a mesh rank's pool holds its slice)."""
    device = resolve_device(device)
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(
            f"paged KV serves attention-KV families only; {cfg.family!r} "
            "keeps O(1) state and stays on the fixed-slot engine")
    if kv_bits not in (0, 8):
        raise ValueError(f"kv_bits must be 0/8, got {kv_bits}")
    dtype = dtype or getattr(torch, cfg.dtype)
    if kv_bits:
        dtype = torch.int8
    dh, nl = cfg.resolved_head_dim, cfg.n_layers
    hkv = cfg.n_kv_heads if n_kv_heads is None else n_kv_heads
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

    A page mapped by ``k`` block tables has ``refcount == k``; the null
    page is never allocated, freed, shared or evicted; a released page
    returns to the free list unless an attached prefix cache holds it
    resident (then it parks as an evictable cached page).
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_len: int, obs=None):
        self.obs = obs if obs is not None else NULL_TELEMETRY
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
        self._cache = None  # attached PrefixCache (eviction provider)
        self.chaos = None   # optional ft.ChaosInjector (page_grant site)

    # -------------------------------------------------------- prefix cache
    def attach_cache(self, cache) -> None:
        """Register a prefix cache as the owner of resident refcount-0
        pages (``cache.holds``) and their evictor (``cache.evict``); the
        capacity arithmetic counts its evictable pages as available."""
        self._cache = cache

    def _emit_pages(self) -> None:
        """Publish pool occupancy (free / cache-resident / evictable) to
        telemetry: the pages track's counter series and the per-step
        memory sample.  Skipped with telemetry off."""
        if self.obs.enabled:
            self.obs.on_pages(
                len(self.free),
                self._cache.cached_pages if self._cache is not None else 0,
                self.evictable_pages)

    # ----------------------------------------------------------- capacity
    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def evictable_pages(self) -> int:
        """Cached refcount-0 pages the attached prefix cache could evict."""
        return self._cache.evictable_count() if self._cache is not None else 0

    @property
    def used_pages(self) -> int:
        return (self.n_pages - len(self._reserved())) - len(self.free)

    @property
    def capacity(self) -> int:
        """The most pages one request can hold."""
        return self.n_pages - 1

    def _reserved(self) -> set:
        """Pages that are never allocated (the null page)."""
        return {NULL_PAGE}

    def shares_pool(self, slot_a: int, slot_b: int) -> bool:
        """Do the two lanes draw pages from one pool (so preempting one
        frees pages for the other)?"""
        return True

    def can_allocate(self, n_pages: int, slot: Optional[int] = None
                     ) -> bool:
        """Could ``n_pages`` fresh pages be produced now (for ``slot``),
        from the free list and then from evictable cached pages?"""
        if n_pages <= len(self.free):
            return True
        return n_pages <= len(self.free) + self.evictable_pages

    # --------------------------------------------------------- allocation
    def _take_for(self, slot: int) -> Optional[int]:
        """A page for ``slot`` (:meth:`_take_page`: any slot's will do)."""
        return self._take_page()

    def _take_page(self) -> Optional[int]:
        """Pop a free page, evicting a cached refcount-0 page first when
        the free list is dry; None when neither has one.  The chaos hook
        fires before the pop: a fired ``page_grant`` fails the grant as a
        dry pool would, so every caller takes its real out-of-capacity
        path (admission blocks, decode preempts, a fork downgrades)."""
        if self.chaos is not None and self.chaos.fire("page_grant"):
            return None
        if not self.free and self._cache is not None:
            self._cache.evict(1)
        if not self.free:
            return None
        return self.free.pop()

    def alloc_page(self, slot: int) -> Optional[int]:
        """Allocate one private page as ``slot``'s next block (refcount
        1): the copy-on-write target of a mid-page cache hit."""
        page = self._take_for(slot)
        if page is None:
            return None
        self.refcount[page] = 1
        self.block_tables[slot, len(self._mapped[slot])] = page
        self._mapped[slot].append(page)
        self._emit_pages()
        return page

    def map_shared(self, slot: int, pages: List[int]) -> None:
        """Map resident (cached) pages as ``slot``'s leading blocks, one
        reference each: the cache-hit path.  Runs before any private
        allocation for the slot."""
        if self._mapped[slot]:
            raise ValueError(
                f"slot {slot} already holds pages; map the shared prefix "
                "before allocating private pages")
        for blk, page in enumerate(pages):
            if page == NULL_PAGE:
                raise ValueError("cannot share the null page")
            self.refcount[page] += 1
            if (self.refcount[page] == 1 and self._cache is not None
                    and self._cache.holds(page)):
                # 0 -> 1: the cached page leaves the evictable set (the
                # prefix pins root first, so the cache's walk up is O(1))
                self._cache._on_pin(page)
            self._mapped[slot].append(page)
            self.block_tables[slot, blk] = page
        self._emit_pages()

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s block table to cover ``n_tokens``; False, with
        the slot exactly as it was, when the pages cannot be produced
        even by eviction.  A grant that fails part way is rolled back
        page by page."""
        need = pages_for(n_tokens, self.page_size)
        if need > self.max_blocks:
            raise ValueError(
                f"slot {slot} wants {n_tokens} tokens > max_len capacity")
        have = len(self._mapped[slot])
        if need <= have:
            return True
        if not self.can_allocate(need - have, slot):
            return False
        granted: List[int] = []
        for blk in range(have, need):
            page = self._take_for(slot)
            if page is None:
                for g in reversed(granted):
                    self._mapped[slot].pop()
                    self.block_tables[slot, len(self._mapped[slot])] = (
                        NULL_PAGE)
                    self._release_page(g)
                self._emit_pages()
                return False
            granted.append(page)
            self.refcount[page] = 1
            self._mapped[slot].append(page)
            self.block_tables[slot, blk] = page
        self._emit_pages()
        return True

    def _release_page(self, page: int) -> None:
        """Drop one reference; at 0 the page returns to the free list
        unless the prefix cache holds it resident (then it stays as an
        evictable cached page).  The only way a page is freed."""
        if page == NULL_PAGE:
            raise ValueError("the null page is never freed")
        self.refcount[page] -= 1
        if self.refcount[page] < 0:
            raise AssertionError(f"page {page} refcount went negative")
        if self.refcount[page] == 0:
            if self._cache is not None and self._cache.holds(page):
                # 1 -> 0: free_slot releases deepest first, so each
                # node's parent is still pinned and the walk up is O(1)
                self._cache._on_unpin(page)
            else:
                self.free.append(page)

    def _reclaim_evicted(self, page: int) -> None:
        """Return an evicted cached page (refcount already 0) to the free
        list.  Called by the prefix cache only."""
        assert page != NULL_PAGE and self.refcount[page] == 0
        self.free.append(page)
        self._emit_pages()

    def free_slot(self, slot: int) -> None:
        """Release every page the slot maps (request retired or
        preempted); shared pages survive under their other owners or the
        prefix cache."""
        for page in reversed(self._mapped[slot]):
            self._release_page(page)
        self._mapped[slot] = []
        self.block_tables[slot, :] = NULL_PAGE
        self.pos[slot] = 0
        self._emit_pages()

    def block_row(self, slot: int) -> np.ndarray:
        """The slot's block-table row (a copy)."""
        return self.block_tables[slot].copy()

    def audit(self) -> None:
        """Prove the bookkeeping invariants; raise :class:`AuditError`
        naming the first violation: the null page is never referenced;
        the free list holds unique in-range refcount-0 pages, disjoint
        from mapped and cache-resident pages; refcounts equal block-table
        references (cache residency takes none); each row is its mapped
        pages then ``NULL_PAGE`` padding; ``pos`` fits the mapped
        capacity; and every page is free, mapped or cache-resident."""
        def fail(msg: str) -> None:
            raise AuditError(f"PageAllocator.audit: {msg}")

        reserved = self._reserved()
        for p in reserved:
            if self.refcount[p] != 0:
                fail(f"null page {p} has refcount {self.refcount[p]}")
        free_set = set(self.free)
        if len(free_set) != len(self.free):
            fail("free list holds duplicate pages")
        for p in self.free:
            if not 0 <= p < self.n_pages or p in reserved:
                fail(f"free list holds out-of-range page {p}")
            if self.refcount[p]:
                fail(f"free page {p} has refcount {self.refcount[p]}")
        cached = set(self._cache.pages()) if self._cache is not None else set()
        if free_set & cached:
            fail(f"page {min(free_set & cached)} is both free and "
                 "cache-resident")
        counts = np.zeros((self.n_pages,), np.int64)
        mapped_set = set()
        for slot in range(self.n_slots):
            mapped, row = self._mapped[slot], self.block_tables[slot]
            n = len(mapped)
            for blk, page in enumerate(mapped):
                if not self._in_pool(slot, page):
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
        leaked = (set(range(self.n_pages)) - reserved - free_set - mapped_set
                  - cached)
        if leaked:
            fail(f"pages leaked (not free, mapped or cached): "
                 f"{sorted(leaked)[:8]}")

    def _in_pool(self, slot: int, page: int) -> bool:
        return NULL_PAGE < page < self.n_pages

    def device_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(block_tables, pos)`` as new int32 tensors on ``device`` (the
        JAX package's function; the engine refills :class:`LaneTables`
        instead)."""
        return (torch.from_numpy(self.block_tables).to(device),
                torch.from_numpy(self.pos).to(device))


class ShardedPageAllocator(PageAllocator):
    """A :class:`PageAllocator` whose lanes and pages are split over
    ``shards`` data shards of a mesh: shard r's lanes ``[r·B/d, (r+1)·B/d)``
    draw pages only from its range ``[r·P/d, (r+1)·P/d)`` of the pool, the
    range a rank of that shard holds.  The first page of every range is
    that shard's null page, never allocated (a rank's local page 0, where
    its idle lanes write).  Block tables hold global page ids;
    :meth:`local_pages` gives one shard's rows in its local ids.

    Preemption frees pages only within a shard (:meth:`shares_pool`).  A
    prefix cache is not attached: a cached page could serve a lane of
    another shard, which does not hold it (the engine keeps lanes and
    pages whole over the data axes when the prefix cache is on).
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_len: int, shards: int, obs=None):
        super().__init__(n_pages, page_size, n_slots, max_len, obs=obs)
        if n_pages % shards or n_slots % shards:
            raise ValueError(f"{n_pages} pages and {n_slots} lanes must "
                             f"both divide over {shards} data shards")
        self.shards = shards
        self.shard_pages = n_pages // shards
        self.shard_lanes = n_slots // shards
        if self.shard_pages < self.max_blocks + 1:
            raise ValueError(
                f"a shard's {self.shard_pages} pages cannot hold one "
                f"max_len={max_len} request (needs {self.max_blocks} pages "
                "+ the shard's null page)")
        self.free = [p for p in self.free if p % self.shard_pages]

    def attach_cache(self, cache) -> None:
        raise NotImplementedError(
            "a prefix cache over pages sharded by data shard: serve with "
            "lanes and pages whole over the data axes")

    @property
    def capacity(self) -> int:
        return self.shard_pages - 1

    def _reserved(self) -> set:
        return set(range(0, self.n_pages, self.shard_pages))

    def shard_of(self, slot: int) -> int:
        return slot // self.shard_lanes

    def shares_pool(self, slot_a: int, slot_b: int) -> bool:
        return self.shard_of(slot_a) == self.shard_of(slot_b)

    def _in_pool(self, slot: int, page: int) -> bool:
        return (page // self.shard_pages == self.shard_of(slot)
                and page % self.shard_pages != 0)

    def _free_in(self, shard: int) -> List[int]:
        return [i for i, p in enumerate(self.free)
                if p // self.shard_pages == shard]

    def can_allocate(self, n_pages: int, slot: Optional[int] = None
                     ) -> bool:
        if slot is None:
            raise ValueError("a sharded pool allocates for a lane: pass "
                             "slot")
        return n_pages <= len(self._free_in(self.shard_of(slot)))

    def _take_for(self, slot: int) -> Optional[int]:
        if self.chaos is not None and self.chaos.fire("page_grant"):
            return None
        held = self._free_in(self.shard_of(slot))
        return self.free.pop(held[-1]) if held else None

    def _take_page(self) -> Optional[int]:
        raise TypeError("a sharded pool grants pages for a lane: "
                        "_take_for(slot)")

    def local_pages(self, rows: np.ndarray, shard: int) -> np.ndarray:
        """Block-table ``rows`` of shard ``shard``'s lanes in the page ids
        local to its range, the unmapped entries left at the null
        page."""
        rows = np.asarray(rows)
        return np.where(rows == NULL_PAGE, NULL_PAGE,
                        rows - shard * self.shard_pages).astype(rows.dtype)


@torch.no_grad()
def fork_tail_page(pages: KVPages, src: int, dst: int) -> None:
    """Copy physical page ``src`` into ``dst`` over every layer of ``k``
    and ``v`` (and of the scale pools when quantized), in place: the
    copy-on-write step of a mid-page prefix-cache hit.

    The whole page is copied: its leading slots are the shared prefix,
    and every slot past the match is overwritten by the request's own
    suffix prefill before anything attends to it.  ``src`` and ``dst``
    are host ints, so the copy is queued on the current stream without a
    sync.  The pool's tensors keep their storage: the serving steps'
    CUDA graphs captured them by address.  (The JAX package's version
    returns a new, donated pool instead.)
    """
    for t in (pages.k, pages.v, pages.k_scale, pages.v_scale):
        if t is not None:
            t[:, dst].copy_(t[:, src])


@torch.no_grad()
def scrub_pages(pages: KVPages, page_ids: List[int]) -> None:
    """Zero physical pages ``page_ids`` over every layer of ``k`` and
    ``v`` (and of the scale pools when quantized), in place.

    A non-finite fault may have written NaN into a lane's pages, and the
    attention paths mask additively (``score + -inf``): a NaN left in the
    masked tail of a reused page would still poison the next tenant's
    softmax.  In an int8 pool the poison sits in the scales, so they are
    zeroed too.  The ids are host ints, taken as runs of consecutive
    pages, so each run is one ``zero_`` queued on the current stream with
    no host sync; the tensors keep their storage, which the serving
    steps' CUDA graphs captured by address.  (The JAX package's
    ``_scrub_slot_pages`` rebinds the pool with ``.at[:, idx].set(0)``.)
    """
    ids = sorted(page_ids)
    runs, start = [], 0
    for i in range(1, len(ids) + 1):
        if i == len(ids) or ids[i] != ids[i - 1] + 1:
            runs.append((ids[start], ids[i - 1] + 1))
            start = i
    for t in (pages.k, pages.v, pages.k_scale, pages.v_scale):
        if t is not None:
            for lo, hi in runs:
                t[:, lo:hi].zero_()


class LaneTables:
    """The per-lane inputs of the serving steps, as persistent device
    buffers: ``tokens`` ``(n_slots, 1)`` and ``active`` ``(n_slots,)``
    bool for a decode step; with ``max_blocks`` the paged step's
    ``block_tables`` ``(n_slots, max_blocks)`` and ``pos``; with
    ``chunk`` the prefill chunk's ``chunk_tokens`` ``(n_slots, chunk)``,
    ``pos0`` and ``seq_lens``.  With ``codebooks`` (the audio family's K)
    the token buffers carry a last axis of K: ``(n_slots, 1, K)`` and
    ``(n_slots, chunk, K)``.  All int32 but ``active``.  ``load`` copies
    host arrays into them in place: their storage never changes, as a
    captured CUDA graph needs."""

    def __init__(self, n_slots: int, device, *, max_blocks: int = 0,
                 chunk: int = 0, codebooks: int = 0):
        def buf(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        per_token = (codebooks,) if codebooks else ()
        self.tokens = buf(n_slots, 1, *per_token)
        self.active = buf(n_slots, dtype=torch.bool)
        if max_blocks:
            self.block_tables = buf(n_slots, max_blocks)
            self.pos = buf(n_slots)
        if chunk:
            self.chunk_tokens = buf(n_slots, chunk, *per_token)
            self.pos0 = buf(n_slots)
            self.seq_lens = buf(n_slots)

    def load(self, **arrays: np.ndarray) -> None:
        """``name=array`` for each buffer to refill."""
        for name, arr in arrays.items():
            getattr(self, name).copy_(torch.from_numpy(np.asarray(arr)))

    def load_tables(self, alloc: PageAllocator) -> None:
        """The allocator's block tables and ``pos``."""
        self.load(block_tables=alloc.block_tables, pos=alloc.pos)
