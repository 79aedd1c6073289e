"""Prefix cache: radix-tree KV reuse with refcounted copy-on-write pages.

* **Radix tree at page granularity.**  A host-side trie over token-id
  prefixes whose nodes own *full* KV pages: a node at depth ``d`` is keyed
  by the ``page_size`` token ids of logical positions ``[d·page_size,
  (d+1)·page_size)`` and owns the physical page holding their K/V for
  every layer.  K/V at position ``t`` depends only on the tokens at
  positions ``<= t``, so every request whose prompt walks the same path
  can map the same physical pages.

* **Matching** (:meth:`PrefixCache.match`) walks full pages, then tries one
  **mid-page** match: when the next cached page agrees with the prompt in
  ``n < page_size`` leading slots, the donor page is copied
  (:func:`repro_torch.serve.pages.fork_tail_page`, copy on write) into a
  private page that the request goes on writing.  The match is capped at
  ``len(prompt) - 1`` tokens, so at least one token runs through
  ``prefill_chunk`` and the request has last-token logits to sample from.

* **Reference counts** live in the
  :class:`~repro_torch.serve.pages.PageAllocator`; the tree holds none.  A
  cached page with refcount 0 is resident but idle: the eviction currency.

* **LRU eviction** (:meth:`PrefixCache.evict`) reclaims refcount-0 cached
  pages leaf first (a match walks a contiguous path from the root) when
  the free list runs dry.  The allocator's ``_take_page`` calls it, so
  eviction always comes before preemption.

All of this is host-side state, like the block tables: the serving steps
and their CUDA graphs see only the pool and the block tables.  Inserts
and evictions report to the engine's telemetry (``on_cache_insert`` /
``on_cache_evict``).  ``snapshot_state`` / ``restore_state`` carry the
tree through ``ServeEngine.snapshot`` / ``restore``.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.telemetry import NULL_TELEMETRY
from repro_torch.serve.pages import NULL_PAGE, AuditError, PageAllocator


class MatchResult:
    """One prompt's cache-hit description (host-side, cheap).

    ``full_pages``: physical page ids whose whole ``page_size`` tokens
    matched, in block order.  ``partial``: ``(donor_page, n_valid)`` when
    the match continues ``n_valid`` tokens into a cached page (the COW
    fork case), else None.  ``matched_tokens``: total prefix length
    served from cache — the request prefills only from there.
    """

    __slots__ = ("full_pages", "partial", "matched_tokens")

    def __init__(self, full_pages: List[int],
                 partial: Optional[Tuple[int, int]], page_size: int):
        self.full_pages = full_pages
        self.partial = partial
        self.matched_tokens = len(full_pages) * page_size + (
            partial[1] if partial else 0)

    def __bool__(self) -> bool:
        return self.matched_tokens > 0


class _Node:
    """One cached full page: key = its page_size token ids, value = the
    physical page id.  Children are the pages that extend this prefix.

    ``blocked_children`` counts children that are *blocked* — pinned
    (refcount > 0) or with blocked descendants of their own.  A node is
    evictable-in-place exactly when it is unblocked (refcount 0 and
    ``blocked_children == 0``): its whole subtree could drain leaf-first.
    The cache maintains these counts incrementally so ``evictable_count``
    is O(1) instead of a full-tree walk per admission check.
    """

    __slots__ = ("children", "parent", "key", "page", "last_used",
                 "blocked_children")

    def __init__(self, parent: Optional["_Node"],
                 key: Optional[Tuple[int, ...]], page: int):
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.key = key
        self.page = page
        self.last_used = 0
        self.blocked_children = 0


class PrefixCache:
    """The radix tree + eviction policy over a :class:`PageAllocator`.

    Construction attaches the cache to the allocator: from then on the
    allocator keeps refcount-0 cached pages resident, counts them as
    allocatable capacity, and evicts through :meth:`evict` when the free
    list runs dry.
    """

    def __init__(self, alloc: PageAllocator, obs=None):
        self.alloc = alloc
        self.obs = obs if obs is not None else NULL_TELEMETRY
        self.page_size = alloc.page_size
        self.root = _Node(None, None, NULL_PAGE)
        self._by_page: Dict[int, _Node] = {}
        self._clock = 0
        # incrementally maintained eviction state: ``_blocked`` counts
        # non-root nodes that are pinned or have blocked descendants (so
        # evictable_count = cached - blocked, O(1)); ``_lru`` is a lazy
        # min-heap of (last_used, page) eviction candidates — entries are
        # validated (and re-queued if merely stale) at pop time instead
        # of being repaired on every touch.
        self._blocked = 0
        self._lru: List[Tuple[int, int]] = []
        # counters (surfaced by ServeEngine.prefix_stats)
        self.hits = 0            # admissions with matched_tokens > 0
        self.misses = 0          # admissions with no match
        self.hit_tokens = 0      # prefill tokens served from cache
        self.cow_forks = 0       # mid-page matches (one page copy each)
        self.inserted_pages = 0
        self.evicted_pages = 0
        # the allocator must notify refcount 0<->1 transitions of cached
        # pages (attach is idempotent; explicit re-attach stays legal)
        alloc.attach_cache(self)

    # ------------------------------------------------------------- basics
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def holds(self, page: int) -> bool:
        """Is this physical page resident in the tree?"""
        return page in self._by_page

    def pages(self):
        """All resident physical page ids (the allocator's audit uses
        this for page-conservation accounting)."""
        return self._by_page.keys()

    @property
    def cached_pages(self) -> int:
        return len(self._by_page)

    # -------------------------------------------- incremental block state
    def _is_blocked(self, node: _Node) -> bool:
        return (node.blocked_children > 0
                or self.alloc.refcount[node.page] > 0)

    def _mark_blocked(self, node: _Node) -> None:
        """``node`` just transitioned unblocked -> blocked; bubble the
        change up, stopping at the first ancestor whose own status does
        not flip (amortized O(1): the pin/unpin orders the allocator
        guarantees make the very first ancestor the stop in the common
        case)."""
        while True:
            self._blocked += 1
            parent = node.parent
            already = self._is_blocked(parent)
            parent.blocked_children += 1
            if parent is self.root or already:
                return
            node = parent

    def _mark_unblocked(self, node: _Node) -> None:
        """Mirror of :meth:`_mark_blocked` for blocked -> unblocked."""
        while True:
            self._blocked -= 1
            if not node.children:
                heapq.heappush(self._lru, (node.last_used, node.page))
            parent = node.parent
            parent.blocked_children -= 1
            if parent is self.root or self._is_blocked(parent):
                return
            node = parent

    def _on_pin(self, page: int) -> None:
        """Allocator hook: a cached page's refcount went 0 -> 1."""
        node = self._by_page[page]
        if node.blocked_children == 0:  # was unblocked; now pinned
            self._mark_blocked(node)

    def _on_unpin(self, page: int) -> None:
        """Allocator hook: a cached page's refcount went 1 -> 0."""
        node = self._by_page[page]
        if node.blocked_children == 0:  # no blocked subtree: unblocks
            self._mark_unblocked(node)

    # ------------------------------------------------------------ matching
    def match(self, tokens) -> MatchResult:
        """Longest cached prefix of ``tokens``, capped at ``len - 1``.

        Touches the LRU clock of every node on the matched path (and the
        mid-page donor).  Does **not** take references — the scheduler
        maps the result through ``PageAllocator.map_shared`` only once
        admission is certain.
        """
        ps = self.page_size
        limit = len(tokens) - 1  # >= 1 token must remain to prefill
        node, full = self.root, []
        d = 0
        while (d + 1) * ps <= limit:
            child = node.children.get(tuple(tokens[d * ps:(d + 1) * ps]))
            if child is None:
                break
            child.last_used = self._tick()
            full.append(child.page)
            node = child
            d += 1
        partial = None
        rem = limit - d * ps
        if rem > 0:
            best_n, best = 0, None
            for key, child in node.children.items():
                n = 0
                while n < rem and key[n] == tokens[d * ps + n]:
                    n += 1
                if n > best_n:
                    best_n, best = n, child
            if best is not None:
                best.last_used = self._tick()
                partial = (best.page, best_n)
        return MatchResult(full, partial, ps)

    # ----------------------------------------------------------- insertion
    def insert(self, tokens, block_row: np.ndarray) -> int:
        """Cache the full pages of a completed prefill.

        ``tokens``: the request's prefill token ids; ``block_row``: its
        block-table row (block ``d`` holds the page covering tokens
        ``[d·ps, (d+1)·ps)``).  Only *full* pages enter the tree — the
        partially-filled tail page keeps being written by decode and stays
        private.  Pages already cached for the same prefix (the request
        was itself a cache hit, or a cold duplicate raced in) are left in
        place; a cold duplicate's private copy simply never becomes
        shared and is freed at retire.  Returns the number of pages newly
        inserted.  Inserting takes no reference: the tree holds pages
        *resident*, the refcount only counts block-table owners.
        """
        ps = self.page_size
        node, new = self.root, 0
        for d in range(len(tokens) // ps):
            key = tuple(int(t) for t in tokens[d * ps:(d + 1) * ps])
            child = node.children.get(key)
            if child is None:
                page = int(block_row[d])
                if page == NULL_PAGE:
                    break  # block table shorter than the prompt: stop
                if page in self._by_page:
                    # a page id can live at one tree position only; this
                    # can't happen for a consistent allocator (shared
                    # pages match the existing node, private pages are
                    # fresh) — guard rather than corrupt the tree.
                    break
                child = _Node(node, key, page)
                node.children[key] = child
                self._by_page[page] = child
                child.last_used = self._tick()
                if self.alloc.refcount[page] > 0:
                    self._mark_blocked(child)  # pinned by its inserter
                else:
                    heapq.heappush(self._lru,
                                   (child.last_used, child.page))
                new += 1
            child.last_used = self._tick()
            node = child
        self.inserted_pages += new
        if new:
            self.obs.on_cache_insert(new)
        return new

    # ------------------------------------------------------------ eviction
    def evictable_count(self) -> int:
        """Pages reclaimable right now: cached nodes whose whole subtree
        (themselves included) is refcount-0 — exactly the pages a
        leaf-first eviction loop could drain.  Exactness matters: the
        scheduler's capacity-based admission counts these as available.

        O(1): ``cached - blocked``, where the blocked count is maintained
        incrementally on refcount 0<->1 transitions (allocator hooks) and
        insert/evict — this runs on *every* capacity check once the free
        list is short, so a full-tree walk per call would slow admission
        at large tree sizes.  (:meth:`_recount_evictable` is the walk,
        kept as the property-test oracle.)
        """
        return len(self._by_page) - self._blocked

    def _recount_evictable(self) -> int:
        """Recompute :meth:`evictable_count` from scratch by a full-tree
        walk: the oracle for the incremental counter (the tests assert
        that they agree after random operation sequences).

        Iterative post-order (a long prompt is one deep chain — one node
        per page — so recursion would hit Python's stack limit at a few
        thousand cached tokens).
        """
        ref = self.alloc.refcount
        # (evictable_in_subtree, whole_subtree_refcount_free) per node
        results: Dict[int, Tuple[int, bool]] = {}
        stack: List[Tuple[_Node, bool]] = [(self.root, False)]
        while stack:
            node, visited = stack.pop()
            if not visited:
                stack.append((node, True))
                for child in node.children.values():
                    stack.append((child, False))
                continue
            total, subtree_free = 0, True
            for child in node.children.values():
                t, f = results.pop(id(child))
                total += t
                subtree_free &= f
            if node is self.root:
                return total
            if subtree_free and ref[node.page] == 0:
                results[id(node)] = (total + 1, True)
            else:
                results[id(node)] = (total, False)
        return 0  # unreachable: the root always completes the walk

    def evict(self, n_pages: int) -> int:
        """Evict up to ``n_pages`` refcount-0 cached pages, LRU leaf-first,
        returning them to the allocator's free list.  Never touches a page
        with live references and never the null page.  Returns the number
        actually evicted.

        Victims pop off a lazy LRU heap in O(log n): entries are
        (last_used, page) snapshots,
        so a popped entry is *validated* against live state — gone,
        re-parented under children, or re-pinned means discard; merely
        touched since queueing means re-queue at its new age.  Evicting a
        leaf may expose its parent as the next candidate; it is pushed
        here rather than tracked on every touch.
        """
        ref = self.alloc.refcount
        evicted = 0
        while evicted < n_pages and self._lru:
            last_used, page = heapq.heappop(self._lru)
            node = self._by_page.get(page)
            if node is None or node.children or ref[page] != 0:
                continue  # stale: evicted already / interior / re-pinned
            if node.last_used != last_used:
                heapq.heappush(self._lru, (node.last_used, page))
                continue  # touched since queued: contend at its new age
            parent = node.parent
            del parent.children[node.key]
            del self._by_page[page]
            # victims are unblocked by construction, so the blocked count
            # and every ancestor's blocked_children are already correct
            self.alloc._reclaim_evicted(page)
            evicted += 1
            if (parent is not self.root and not parent.children
                    and ref[parent.page] == 0):
                heapq.heappush(self._lru, (parent.last_used, parent.page))
        self.evicted_pages += evicted
        if evicted:
            self.obs.on_cache_evict(evicted)
        return evicted

    # --------------------------------------------------- snapshot / restore
    def snapshot_state(self) -> Dict:
        """JSON-able tree state for ``ServeEngine.snapshot()``.

        Nodes are listed in DFS preorder (every parent precedes its
        children) keyed by page id: page ids are unique tree positions,
        so ``parent`` page 0 (the null page, the root's id) means the
        root.  The incremental eviction state (``_blocked``,
        ``blocked_children``, the LRU heap) is derived state and is not
        stored: :meth:`restore_state` recomputes it from the refcounts.
        """
        nodes: List[Dict] = []
        stack: List[_Node] = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root:
                nodes.append({
                    "page": int(node.page),
                    "key": [int(t) for t in node.key],
                    "parent": (int(node.parent.page)
                               if node.parent is not self.root else 0),
                    "last_used": int(node.last_used),
                })
            stack.extend(node.children.values())
        return {
            "nodes": nodes,
            "clock": self._clock,
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "cow_forks": self.cow_forks,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
        }

    def restore_state(self, state: Dict) -> None:
        """Rebuild the tree from :meth:`snapshot_state`.

        The allocator's refcounts must already be restored: the blocked
        counters are recomputed bottom-up from them.  Every node goes onto
        the LRU heap, an over-approximation that the heap's pop-time
        validation discards (interior or pinned entries are skipped, stale
        ages re-queue).
        """
        self.root = _Node(None, None, NULL_PAGE)
        self._by_page = {}
        for n in state["nodes"]:  # preorder: parents already rebuilt
            parent = (self.root if n["parent"] == 0
                      else self._by_page[n["parent"]])
            key = tuple(n["key"])
            node = _Node(parent, key, n["page"])
            node.last_used = n["last_used"]
            parent.children[key] = node
            self._by_page[n["page"]] = node
        # the blocked state bottom-up (post-order = reversed preorder)
        ref = self.alloc.refcount
        order: List[_Node] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            order.append(node)
            stack.extend(node.children.values())
        blocked: Dict[int, bool] = {}
        self._blocked = 0
        for node in reversed(order):
            node.blocked_children = sum(
                1 for c in node.children.values() if blocked[id(c)])
            if node is self.root:
                continue
            b = bool(node.blocked_children > 0 or ref[node.page] > 0)
            blocked[id(node)] = b
            self._blocked += b
        self._lru = [(node.last_used, page)
                     for page, node in self._by_page.items()]
        heapq.heapify(self._lru)
        self._clock = state["clock"]
        self.hits = state["hits"]
        self.misses = state["misses"]
        self.hit_tokens = state["hit_tokens"]
        self.cow_forks = state["cow_forks"]
        self.inserted_pages = state["inserted_pages"]
        self.evicted_pages = state["evicted_pages"]

    # -------------------------------------------------------------- audit
    def audit(self) -> None:
        """Prove the tree's structural and counter invariants; raise
        :class:`~repro_torch.serve.pages.AuditError` naming the first violation.

        Checked:

        * tree structure — parent/child links agree, dict keys match node
          keys, no node owns the null page, ``_by_page`` is exactly the
          set of reachable nodes (no orphans, no strays);
        * the incremental eviction state — every node's
          ``blocked_children`` equals a fresh recount, ``_blocked``
          equals the number of blocked nodes, and the O(1)
          ``evictable_count()`` equals the post-order
          :meth:`_recount_evictable` oracle;
        * evictability liveness — every currently-evictable leaf has an
          entry on the lazy LRU heap (lazy deletion may leave *extra*
          entries, never missing ones — a missing entry is a page that
          could never be reclaimed).
        """
        def fail(msg: str) -> None:
            raise AuditError(f"PrefixCache.audit: {msg}")

        ref = self.alloc.refcount
        reachable: Dict[int, _Node] = {}
        stack: List[_Node] = [self.root]
        order: List[_Node] = []  # pre-order; reversed = post-order
        while stack:
            node = stack.pop()
            order.append(node)
            for key, child in node.children.items():
                if child.parent is not node:
                    fail(f"page {child.page}: parent link does not match "
                         "its position in the tree")
                if child.key != key:
                    fail(f"page {child.page}: node key {child.key} != dict "
                         f"key {key}")
                if child.page == NULL_PAGE:
                    fail("a tree node owns the null page")
                if child.page in reachable:
                    fail(f"page {child.page} appears at two tree positions")
                reachable[child.page] = child
                stack.append(child)
        if set(reachable) != set(self._by_page):
            orphans = set(self._by_page) - set(reachable)
            strays = set(reachable) - set(self._by_page)
            fail(f"_by_page does not match the reachable tree "
                 f"(orphans={sorted(orphans)[:8]}, "
                 f"strays={sorted(strays)[:8]})")
        for page, node in reachable.items():
            if self._by_page[page] is not node:
                fail(f"_by_page[{page}] points at a different node")

        # post-order recount of the incremental blocked state
        blocked: Dict[int, bool] = {}
        n_blocked = 0
        for node in reversed(order):
            count = sum(1 for c in node.children.values()
                        if blocked[id(c)])
            if node.blocked_children != count:
                fail(f"page {node.page}: blocked_children "
                     f"{node.blocked_children} != recount {count}")
            if node is self.root:
                continue
            is_blocked = count > 0 or ref[node.page] > 0
            blocked[id(node)] = is_blocked
            n_blocked += is_blocked
        if self._blocked != n_blocked:
            fail(f"_blocked {self._blocked} != recount {n_blocked}")
        if self.evictable_count() != self._recount_evictable():
            fail(f"evictable_count() {self.evictable_count()} != "
                 f"post-order recount {self._recount_evictable()}")

        # every evictable leaf must be reclaimable through the heap
        heap_pages = {page for _, page in self._lru}
        for page, node in self._by_page.items():
            if (not node.children and ref[page] == 0
                    and page not in heap_pages):
                fail(f"evictable leaf page {page} has no LRU heap entry")

    # ------------------------------------------------------------- reports
    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "cow_forks": self.cow_forks,
            "cached_pages": self.cached_pages,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "evictable": self.evictable_count(),
        }
