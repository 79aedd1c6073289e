"""FCFS scheduling for the paged continuous-batching engine.

The scheduler owns the request queue and the lane table and decides,
host-side and against the :class:`~repro_torch.serve.pages.PageAllocator`:

* **Admission** — FCFS by capacity: the head-of-queue request is admitted
  into a free lane only when the pool can hold its whole prefill (prompt,
  plus tokens generated before a preemption) and one decode token.  Pages
  are granted up front, so chunked prefill never allocates mid-flight.
* **Chunked batched prefill** — every admitted, unfinished request gives
  its next <= ``chunk`` prompt tokens to one batched ``prefill_chunk``.
* **Preemption** — when decode needs a page and the free list is dry, the
  longest-running request (earliest admission still resident) is evicted
  and re-enters the queue head with ``prompt + generated-so-far`` as its
  new prefill (recompute-style: greedy decode resumes exactly).
"""

from __future__ import annotations

import collections
from typing import Deque, List, Optional, Tuple

import numpy as np

from repro_torch.serve.pages import PageAllocator

PrefillBatch = Tuple[np.ndarray, np.ndarray, np.ndarray,
                     List[Tuple[int, int]]]


class PagedScheduler:
    """Admission + prefill batching + preemption over ``n_slots`` lanes."""

    def __init__(self, alloc: PageAllocator, chunk: int):
        self.alloc = alloc
        self.chunk = int(chunk)
        if self.chunk < 1:
            raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
        self.n_slots = alloc.n_slots
        self.queue: Deque = collections.deque()
        self.slot_req: List[Optional[object]] = [None] * self.n_slots
        self.preemptions = 0
        self._admit_seq = 0

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
        toks = req.prefill_tokens
        if not self.alloc.can_admit(len(toks)):
            return False
        self.alloc.pos[slot] = 0
        if not self.alloc.ensure(slot, len(toks) + 1):
            self.alloc.free_slot(slot)
            return False
        self.slot_req[slot] = req
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        req.prefill_pos = 0
        return True

    def prefill_batch(self) -> Optional[PrefillBatch]:
        """The next chunked prefill batch: ``(tokens (n_slots, chunk),
        pos0, seq_lens, [(slot, n_real), ...])``, or None when nothing is
        pending.  Every pending lane advances by up to ``chunk`` tokens."""
        c = self.chunk
        tokens = np.zeros((self.n_slots, c), np.int32)
        pos0 = np.zeros((self.n_slots,), np.int32)
        seq_lens = np.zeros((self.n_slots,), np.int32)
        lanes: List[Tuple[int, int]] = []
        for slot, req in enumerate(self.slot_req):
            if req is None or req.prefill_pos >= len(req.prefill_tokens):
                continue
            n_real = min(c, len(req.prefill_tokens) - req.prefill_pos)
            tokens[slot, :n_real] = req.prefill_tokens[
                req.prefill_pos:req.prefill_pos + n_real]
            pos0[slot] = req.prefill_pos
            seq_lens[slot] = req.prefill_pos + n_real
            lanes.append((slot, n_real))
        if not lanes:
            return None
        return tokens, pos0, seq_lens, lanes

    def decode_lanes(self) -> List[Tuple[int, object]]:
        """Lanes whose request is fully prefilled and ready to decode."""
        return [(s, r) for s, r in enumerate(self.slot_req)
                if r is not None
                and r.prefill_pos >= len(r.prefill_tokens)
                and r.last_logits is not None]

    def grant_decode_page(self, slot: int) -> bool:
        """Make room for ``slot``'s next decode token, preempting the
        longest-running other request if the free list is dry; False only
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
        """Longest-running resident request = earliest admission."""
        best, best_seq = None, None
        for slot, req in enumerate(self.slot_req):
            if req is None or slot == exclude:
                continue
            if best_seq is None or req.admit_seq < best_seq:
                best, best_seq = slot, req.admit_seq
        return best

    def _preempt(self, slot: int) -> None:
        req = self.slot_req[slot]
        self.alloc.free_slot(slot)
        self.slot_req[slot] = None
        req.prefill_tokens = list(req.prompt) + list(req.output)
        req.prefill_pos = 0
        req.last_logits = None
        req.preemptions += 1
        self.preemptions += 1
        self.queue.appendleft(req)
