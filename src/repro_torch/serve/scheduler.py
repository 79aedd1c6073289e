"""Scheduling for the paged continuous-batching engine.

The scheduler owns the request queue and the lane table and decides,
host-side and against the :class:`~repro_torch.serve.pages.PageAllocator`:

* **Admission** — FCFS by capacity: the head-of-queue request is admitted
  into a free lane only when the pool can hold its whole prefill (prompt,
  plus tokens generated before a preemption) and one decode token.  Pages
  are granted up front, so chunked prefill never allocates mid-flight.
* **Chunked batched prefill** — every admitted, unfinished request gives
  its next <= ``chunk`` prompt tokens to one batched ``prefill_chunk``.
* **Preemption** — when decode needs a page and the pool is dry, the
  longest-running request (earliest admission still resident) is evicted
  and re-enters the queue head with ``prompt + generated-so-far`` as its
  new prefill (recompute-style: greedy decode resumes exactly).  With a
  prefix cache attached, cache eviction (inside the allocator) always
  comes first.

With a :class:`~repro_torch.serve.prefix_cache.PrefixCache`, admission
matches the prompt against the radix tree: matched full pages are mapped
shared into the lane's block table, a mid-page match records a pending
copy-on-write fork (the engine copies the page before the next prefill),
and the lane's prefill starts at the matched length, so ``prefill_chunk``
computes only the unmatched suffix.

:class:`BudgetScheduler` adds a per-step **token budget** shared between
decode (one token per ready lane, funded first) and chunked prefill (the
remainder), **priority classes** with weighted fair-share virtual time
per ``(tenant, priority)`` key, and admission that skips over requests
that do not fit.  Both policies drive the same lane-independent steps, so
greedy tokens are the same under either.

Admissions, cache hits and misses and preemptions report to the engine's
telemetry; :meth:`PagedScheduler.preempt_storm` is the ``preempt_storm``
chaos site's mass eviction.
"""

from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.telemetry import NULL_TELEMETRY
from repro_torch.serve.pages import PageAllocator, pages_for

PrefillBatch = Tuple[np.ndarray, np.ndarray, np.ndarray,
                     List[Tuple[int, int]]]

# weighted fair-share classes: an active interactive key receives 8x the
# prefill+decode tokens of an active batch key (never starving either —
# virtual time advances for whoever is served, so every key's turn comes)
PRIORITY_WEIGHTS: Dict[str, float] = {
    "interactive": 8.0,
    "default": 4.0,
    "batch": 1.0,
}


class PagedScheduler:
    """Admission + prefill batching + preemption over ``n_slots`` lanes."""

    def __init__(self, alloc: PageAllocator, chunk: int,
                 prefix_cache=None, obs=None):
        self.alloc = alloc
        self.obs = obs if obs is not None else NULL_TELEMETRY
        self.chunk = int(chunk)
        if self.chunk < 1:
            raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
        self.n_slots = alloc.n_slots
        self.queue: Deque = collections.deque()
        self.slot_req: List[Optional[object]] = [None] * self.n_slots
        self.preemptions = 0
        self._admit_seq = 0
        self.prefix_cache = prefix_cache
        # (slot, src_page, dst_page) page copies the engine runs before
        # the next step touches the forked pages; tagged with the owning
        # slot so that cancellation, preemption and retirement drop a
        # freed slot's forks before its dst page can be reused
        self.pending_forks: List[Tuple[int, int, int]] = []
        # prefill tokens actually computed (cache hits keep it below the
        # total of the prompts)
        self.prefill_computed = 0

    def drop_forks(self, slot: int) -> None:
        """Discard the pending forks owned by ``slot`` (its request left
        before the engine ran the copy; the dst page is being freed)."""
        self.pending_forks = [f for f in self.pending_forks
                              if f[0] != slot]

    # --------------------------------------------------------- admission
    def admit(self) -> None:
        """FCFS admission while a lane is free and capacity allows; the
        head of the queue blocks it when it does not fit."""
        for slot in range(self.n_slots):
            if not self.queue:
                return
            if self.slot_req[slot] is not None:
                continue
            if not self._try_admit(slot, self.queue[0]):
                return
            self.queue.popleft()

    def _try_admit(self, slot: int, req) -> bool:
        """Admit ``req`` into free lane ``slot`` if capacity allows;
        False, with the allocator untouched, otherwise.  The caller owns
        the queue.

        With a prefix cache the prompt is matched before the capacity
        check: shared full pages cost nothing, so a request whose prefix
        is resident fits a pool that could not hold its cold prefill.
        Pages for the whole suffix prefill plus one decode token are
        still granted up front.
        """
        toks = req.prefill_tokens
        total = pages_for(len(toks) + 1, self.alloc.page_size)
        # not even a best-case match (every full page shared) fits: skip
        # the tree walk and the pin / rollback
        if not self.alloc.can_allocate(
                total - len(toks) // self.alloc.page_size, slot):
            return False
        match = None
        if self.prefix_cache is not None:
            match = self.prefix_cache.match(toks)
        n_shared = len(match.full_pages) if match else 0
        if n_shared:
            # pin the matched pages before the capacity check: a
            # refcount-0 cached page counts as evictable capacity, and a
            # page about to be shared must not be promised to eviction too
            self.alloc.map_shared(slot, match.full_pages)
        need = total - n_shared
        if not self.alloc.can_allocate(need, slot):
            if n_shared:
                self.alloc.free_slot(slot)  # unpin; the pages stay cached
            return False
        # the fork target is granted first: a failed grant downgrades the
        # mid-page match (its tokens prefill normally) rather than failing
        # the admission
        fork = None
        if match is not None and match.partial is not None:
            dst = self.alloc.alloc_page(slot)
            if dst is None:
                match.partial = None
                match.matched_tokens = n_shared * self.alloc.page_size
            else:
                fork = (slot, match.partial[0], dst)
        matched = match.matched_tokens if match is not None else 0
        self.alloc.pos[slot] = matched
        if not self.alloc.ensure(slot, len(toks) + 1):
            # capacity said yes but the grant failed part way: roll the
            # whole admission back (pins and fork target release through
            # free_slot); the request stays queued
            self.alloc.free_slot(slot)
            return False
        self.slot_req[slot] = req
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        if match is not None:
            self.prefix_cache.hits += bool(matched)
            self.prefix_cache.misses += not matched
            self.prefix_cache.hit_tokens += matched
            if matched:
                self.obs.on_cache_hit(req.rid, matched,
                                      match.partial is not None)
            else:
                self.obs.on_cache_miss(req.rid)
            if fork is not None:
                self.pending_forks.append(fork)
                self.prefix_cache.cow_forks += 1
        req.prefill_pos = matched
        req.cached_tokens = matched
        self.obs.on_admit(req.rid, slot, matched)
        return True

    # ----------------------------------------------------------- prefill
    def _pick_prefill(self) -> List[Tuple[int, int]]:
        """``(slot, n_tokens)`` prefill work for this step: every pending
        lane advances by up to ``chunk`` tokens (FCFS has no budget;
        subclasses ration here)."""
        picks = []
        for slot, req in enumerate(self.slot_req):
            if req is None or req.prefill_pos >= len(req.prefill_tokens):
                continue
            picks.append(
                (slot, min(self.chunk,
                           len(req.prefill_tokens) - req.prefill_pos)))
        return picks

    def charge_decode(self, ready: List[Tuple[int, object]]) -> None:
        """Account for one decode token per ready lane this step (the
        engine calls it right before the decode step).  FCFS keeps no
        accounts; the budget scheduler charges fair-share virtual time."""

    def prefill_batch(self, audio_codebooks: int = 0
                      ) -> Optional[PrefillBatch]:
        """The next chunked prefill batch: ``(tokens (n_slots, chunk),
        pos0, seq_lens, [(slot, n_real), ...])``, or None when nothing is
        pending.  Lanes and token counts come from ``_pick_prefill``.
        With ``audio_codebooks`` K > 1 the tokens are ``(n_slots, chunk,
        K)``: each prompt id broadcast over the K codebooks, as the JAX
        package feeds the audio family."""
        c = self.chunk
        tokens = np.zeros((self.n_slots, c), np.int32)
        pos0 = np.zeros((self.n_slots,), np.int32)
        seq_lens = np.zeros((self.n_slots,), np.int32)
        lanes: List[Tuple[int, int]] = []
        for slot, n_real in self._pick_prefill():
            req = self.slot_req[slot]
            tokens[slot, :n_real] = req.prefill_tokens[
                req.prefill_pos:req.prefill_pos + n_real]
            pos0[slot] = req.prefill_pos
            seq_lens[slot] = req.prefill_pos + n_real
            lanes.append((slot, n_real))
            self.prefill_computed += n_real
        if not lanes:
            return None
        if audio_codebooks > 1:
            tokens = np.broadcast_to(
                tokens[..., None],
                tokens.shape + (audio_codebooks,)).copy()
        return tokens, pos0, seq_lens, lanes

    def decode_lanes(self) -> List[Tuple[int, object]]:
        """Lanes whose request is fully prefilled and ready to decode."""
        return [(s, r) for s, r in enumerate(self.slot_req)
                if r is not None
                and r.prefill_pos >= len(r.prefill_tokens)
                and r.last_logits is not None]

    def lane_mask(self, slots) -> np.ndarray:
        """``(n_slots,)`` bool mask of the lanes a step advances."""
        mask = np.zeros((self.n_slots,), bool)
        mask[list(slots)] = True
        return mask

    # -------------------------------------------------------- preemption
    def grant_decode_page(self, slot: int) -> bool:
        """Make room for ``slot``'s next decode token, preempting the
        longest-running other request if the pool is dry; False only
        when no victim remains."""
        if self.slot_req[slot] is None:
            return False  # never grow an empty slot
        want = int(self.alloc.pos[slot]) + 1
        while not self.alloc.ensure(slot, want):
            victim = self._pick_victim(exclude=slot)
            if victim is None:
                return False
            self._preempt(victim)
        return True

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """Longest-running resident request = earliest admission, among
        the lanes that draw pages from ``exclude``'s pool."""
        best, best_seq = None, None
        for slot, req in enumerate(self.slot_req):
            if (req is None or slot == exclude
                    or not self.alloc.shares_pool(slot, exclude)):
                continue
            if best_seq is None or req.admit_seq < best_seq:
                best, best_seq = slot, req.admit_seq
        return best

    def _preempt(self, slot: int) -> None:
        req = self.slot_req[slot]
        self.obs.on_preempt(req.rid, slot)
        self.alloc.free_slot(slot)
        self.slot_req[slot] = None
        # recompute-style: everything generated so far becomes prefill (a
        # prefix still resident in the cache is matched again)
        req.prefill_tokens = list(req.prompt) + list(req.output)
        req.prefill_pos = 0
        req.cached_tokens = 0
        req.last_logits = None
        req.preemptions += 1
        self.preemptions += 1
        self.drop_forks(slot)
        self.queue.appendleft(req)

    def preempt_storm(self) -> int:
        """Preempt every resident request (the chaos injector's
        ``preempt_storm`` site, a mass-eviction drill).  Recompute-style
        preemption keeps greedy tokens, so a storm costs latency and
        prefill compute, never tokens.  Returns the lanes preempted."""
        n = 0
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None:
                self._preempt(slot)
                n += 1
        return n


class BudgetScheduler(PagedScheduler):
    """SLA-aware scheduling: per-step token budget + weighted fair share.

    The data path (chunked prefill, page grants, preemption) is the FCFS
    scheduler's, so greedy tokens are the same under either:

    * **Per-step token budget** (``step_tokens``): decode is funded first
      (every ready lane advances one token every step); the rest of the
      budget is rationed to chunked prefill in fair-share order.
      Completing a prompt's prefill reserves one more token (its first
      decode runs in the same engine step); when that reserve does not
      fit, the tail waits a step, so the budget holds in every step.
    * **Weighted fair share** across ``(tenant, priority)`` keys: serving
      ``n`` tokens to a key advances its virtual time by ``n / weight``
      (:data:`PRIORITY_WEIGHTS`); admission and prefill serve the lowest
      virtual time first.  An idle key's clock is raised to the lowest
      active one when it returns, so sleeping banks no credit.
    * **Out-of-order admission**: a request that does not fit does not
      block later ones that do (lowest virtual time first; arrival order
      breaks ties within a key).
    """

    def __init__(self, alloc: PageAllocator, chunk: int,
                 prefix_cache=None, obs=None, *, step_tokens: int):
        super().__init__(alloc, chunk, prefix_cache=prefix_cache, obs=obs)
        self.step_tokens = int(step_tokens)
        # >= 2: one token of prefill progress plus the completion reserve
        # must fit an otherwise idle step, or a 1-token tail would wait
        # forever
        if self.step_tokens < 2:
            raise ValueError(
                f"step_tokens must be >= 2, got {step_tokens}")
        self._vtime: Dict[Tuple[str, str], float] = {}

    # ------------------------------------------------------- fair share
    def _key(self, req) -> Tuple[str, str]:
        return (getattr(req, "tenant", "default"),
                getattr(req, "priority", "default"))

    def _weight(self, req) -> float:
        return PRIORITY_WEIGHTS.get(getattr(req, "priority", "default"),
                                    1.0)

    def _vfloor(self) -> float:
        """Lowest virtual time among the active keys (queued or
        resident): the floor an idle key returns at."""
        keys = {self._key(r) for r in self.queue}
        keys.update(self._key(r) for r in self.slot_req if r is not None)
        vals = [self._vtime[k] for k in keys if k in self._vtime]
        return min(vals, default=0.0)

    def _charge(self, req, n_tokens: int) -> None:
        """Advance ``req``'s key by ``n_tokens`` of service."""
        k = self._key(req)
        vt = max(self._vtime.get(k, 0.0), self._vfloor())
        self._vtime[k] = vt + n_tokens / self._weight(req)

    def _service_order(self, reqs):
        """Lowest virtual time first; fresh keys start at the floor and
        break ties by weight (heavier class first), then arrival."""
        floor = self._vfloor()
        return sorted(
            reqs, key=lambda r: (self._vtime.get(self._key(r), floor),
                                 -self._weight(r), r.rid))

    # --------------------------------------------------------- admission
    def admit(self) -> None:
        """Admit queued requests in fair-share order, skipping any that
        do not fit (no head-of-line blocking)."""
        free = [s for s in range(self.n_slots) if self.slot_req[s] is None]
        if not free or not self.queue:
            return
        for req in self._service_order(list(self.queue)):
            if not free:
                return
            if self._try_admit(free[0], req):
                self.queue.remove(req)
                free.pop(0)

    # ----------------------------------------------------------- prefill
    def _ready_decoders(self) -> int:
        """Lanes that will take a decode token this step."""
        return sum(1 for _, r in self.decode_lanes()
                   if len(r.output) < r.max_new_tokens)

    def _pick_prefill(self) -> List[Tuple[int, int]]:
        """Ration the step's remaining budget to pending prefills, lowest
        virtual time first."""
        budget = self.step_tokens - self._ready_decoders()
        slot_of = {id(r): s for s, r in enumerate(self.slot_req)
                   if r is not None}
        pending = [r for r in self.slot_req
                   if r is not None
                   and r.prefill_pos < len(r.prefill_tokens)]
        picks: List[Tuple[int, int]] = []
        for req in self._service_order(pending):
            if budget <= 0:
                break
            slot = slot_of[id(req)]
            rem = len(req.prefill_tokens) - req.prefill_pos
            n = min(self.chunk, rem, budget)
            if n == rem and n + 1 > budget:
                # completing the prefill costs its first decode token in
                # the same step: defer the tail rather than overshoot
                n -= 1
            if n <= 0:
                continue
            picks.append((slot, n))
            budget -= n + (1 if n == rem else 0)
            self._charge(req, n)
        return picks

    def charge_decode(self, ready: List[Tuple[int, object]]) -> None:
        for _, req in ready:
            self._charge(req, 1)
