"""Continuous-batching serving engine over a paged KV cache (the default
for the dense family) or a fixed-slot cache (the ssm family's mode).

**Paged mode** (``mode="paged"``): KV state lives in a shared page pool
(:mod:`repro_torch.serve.pages`) addressed through per-request block
tables; the FCFS scheduler (:mod:`repro_torch.serve.scheduler`) admits
requests by page capacity, prefills prompts in batched chunks through
``prefill_chunk`` (one forward per chunk across all pending lanes),
decodes one token per step for every ready lane, and preempts the
longest-running request when pages run out.

**Fixed-slot mode** (``mode="slots"``, and what ``mode="auto"`` falls
back to, with a warning, for the ssm family, whose O(1) recurrent state
has nothing to page): a fixed ``(n_slots, max_len)`` cache rectangle,
prompts entering by sequential decode one slot at a time, and one
full-sequence ``decode_step`` per token across the active slots.  A slot
that does not advance keeps every cache entry bit-identical, as the JAX
package's ``_merge_cache`` leaves it: ``decode_step``'s ``active`` lanes
select where the step writes (the K/V row of each lane, the conv and h
states it writes whole anyway, ``pos``), never the whole cache.

Every linear runs through one :class:`~repro_torch.engine.EnginePlan`
resolved at construction; with ``EngineConfig.kv_bits = 8`` the pools are
int8 (paged mode only).  On a CUDA device the plan's ``auto`` backends are
the hand-written kernels (GEMV and paged attention); on the CPU they are
the plain PyTorch paths.

On a CUDA device each fixed-shape step (the paged decode step at
``(n_slots, 1)``, the prefill chunk at ``(n_slots, chunk)``, the slots
step at ``(n_slots, 1)``) is a captured CUDA graph replayed from static
lane buffers (:mod:`repro_torch.serve.step_graph`), the port's
counterpart of the JAX package's ``jax.jit`` of ``_dec``, ``_pf`` and
``_step``.  ``cuda_graphs=False`` runs them eagerly, as
``jax.disable_jit()`` would; on the CPU they always run eagerly.

Not ported yet, and refused at construction rather than ignored: the
prefix cache, the budget scheduler and runtime audits (in slots mode
refused or warned about as the JAX package does), per-request retry /
quarantine, telemetry, and the families other than dense and ssm (the
audio family's token layout among them).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Deque, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ServeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import resolve_attn_backend, resolve_plan
from repro_torch.models.transformer import (
    decode_step,
    decode_step_paged,
    init_cache,
    prefill_chunk as _prefill_chunk_fn,
    quantize_params,
)
from repro_torch.serve.pages import (
    LaneTables,
    PageAllocator,
    init_kv_pages,
    pages_for,
)
from repro_torch.serve.sampler import sample
from repro_torch.serve.scheduler import PagedScheduler
from repro_torch.serve.step_graph import StepGraph

logger = logging.getLogger(__name__)

SERVE_FAMILIES = ("dense", "ssm")
PAGED_FAMILIES = ("dense",)


class AdmissionRejected(RuntimeError):
    """Load shedding: ``submit`` refused the request (``reason`` is
    ``"queue_full"`` or ``"pool_too_small"``)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# eq=False: a Request is an identity (queue membership and lane residency
# compare by ``is``)
@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # logits of the most recent token, fed to the next sampling step
    last_logits: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)
    prefill_tokens: List[int] = dataclasses.field(
        default_factory=list, repr=False)
    prefill_pos: int = 0
    admit_seq: int = -1
    preemptions: int = 0
    cancelled: bool = False
    finish_reason: Optional[str] = None   # "length" | "cancelled"


def _not_ported(scfg: ServeConfig) -> List[str]:
    """The paged-mode options that are not ported yet."""
    missing = []
    if scfg.prefix_cache:
        missing.append("prefix_cache")
    if scfg.sched != "fcfs":
        missing.append(f"sched={scfg.sched!r}")
    if scfg.audit:
        missing.append("audit")
    return missing


def _resolve_mode(mode: str, family: str) -> Tuple[str, bool]:
    """``(mode, auto_fallback)`` as the JAX package resolves them: ``auto``
    is paged for the families with a pageable KV cache and slots, with a
    warning that names the family, for the others."""
    if mode == "auto":
        if family in PAGED_FAMILIES:
            return "paged", False
        logger.warning(
            "ServeEngine: family %r has no pageable KV cache; falling back "
            "to mode='slots' (fixed-slot engine, no paging, no prefix "
            "cache)", family)
        return "slots", True
    if mode == "paged" and family not in PAGED_FAMILIES:
        raise ValueError(f"family {family!r} has no pageable KV cache; "
                         "use mode='slots'")
    if mode not in ("paged", "slots"):
        raise ValueError(f"unknown serve mode {mode!r}")
    return mode, False


def _check_slots_options(scfg: ServeConfig, auto_fallback: bool) -> None:
    """The paged-pool options in slots mode, as the JAX package treats
    them: refused with ``ValueError`` when slots mode was asked for;
    after ``auto``'s fallback the prefix cache is dropped silently (the
    fallback's warning names the family) and the others are ignored with
    a warning."""
    if scfg.prefix_cache and not auto_fallback:
        raise ValueError(
            "prefix_cache shares KV *pages* across requests; mode='slots' "
            "has no page pool to share")
    if scfg.sched == "budget":
        if not auto_fallback:
            raise ValueError(
                "sched='budget' interleaves chunked prefill with decode "
                "under a token budget; mode='slots' prefills synchronously "
                "and has no scheduler to budget")
        logger.warning("ServeEngine: sched='budget' ignored in mode='slots' "
                       "(fixed-slot fallback runs FCFS)")
    if scfg.audit:
        if not auto_fallback:
            raise ValueError("audit proves page-pool invariants; "
                             "mode='slots' has no page pool to audit")
        logger.warning("ServeEngine: audit ignored in mode='slots' "
                       "(no page pool)")


class ServeEngine:
    """Continuous-batching serving over a paged or a fixed-slot cache.

    ``device``: where the model runs; None means the GPU, and raises on a
    host without one.  ``params`` are quantized at construction when the
    plan packs weights.  ``mode``: ``"paged"`` | ``"slots"`` | ``"auto"``
    (None defers to ``ServeConfig.mode``).  ``page_size`` / ``n_pages`` /
    ``prefill_chunk`` configure the paged pool and default to the
    :class:`ServeConfig`'s; ``n_pages=0`` sizes the pool to the full
    ``n_slots × max_len`` rectangle (never preempts).  ``attn_backend``
    (``gather`` / ``cuda``) overrides the plan's.

    ``cuda_graphs``: on a CUDA device, run each step as a replayed CUDA
    graph (the default) or eagerly (False); the params and the pool or
    cache are captured by address and must not be rebound.  ``timings``
    records the host-clock seconds of every prefill chunk (in slots mode,
    every prompt's sequential prefill) and decode step, each measured up
    to the host sync that reads its logits, and apart from them the
    seconds of each graph capture (``"capture"``).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        scfg: Optional[ServeConfig] = None,
        *,
        n_slots: int = 4,
        max_len: int = 256,
        seed: int = 0,
        mode: Optional[str] = None,
        page_size: Optional[int] = None,
        n_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        attn_backend: Optional[str] = None,
        cuda_graphs: bool = True,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.scfg = scfg or ServeConfig()
        if cfg.family not in SERVE_FAMILIES:
            raise NotImplementedError(
                f"serving family {cfg.family!r} is not ported yet")
        self.mode, auto_fallback = _resolve_mode(mode or self.scfg.mode,
                                                 cfg.family)
        if self.mode == "paged":
            missing = _not_ported(self.scfg)
            if missing:
                raise NotImplementedError(
                    f"not ported yet: {', '.join(missing)}")
        else:
            _check_slots_options(self.scfg, auto_fallback)
        self.device = resolve_device(device)
        # the EngineConfig is resolved into an EnginePlan exactly once
        self.plan = resolve_plan(self.scfg.engine, device=self.device)
        self.kv_bits = self.plan.kv_bits if self.plan is not None else 0
        if self.kv_bits and self.mode == "slots":
            raise ValueError(
                "kv_bits is wired through the paged engine (int8 KV pages); "
                "mode='slots' serves the full-precision cache only")
        if self.plan is not None and self.plan.bits:
            params = quantize_params(params, cfg, self.plan.bits)
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.generator = torch.Generator().manual_seed(seed)
        self.attn_backend = resolve_attn_backend(
            attn_backend
            or (self.plan.attn_backend if self.plan is not None
                else self.scfg.engine.attn_backend),
            self.device)
        self._next_rid = 0
        self.timings: Dict[str, List[float]] = {"prefill": [], "decode": [],
                                                "capture": []}
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.cuda_graphs else None)
        self._graphs: List[StepGraph] = []
        if self.mode == "paged":
            self._init_paged(page_size, n_pages, prefill_chunk)
        else:
            self._init_slots()

    def _init_paged(self, page_size, n_pages, prefill_chunk) -> None:
        self.page_size = page_size or self.scfg.page_size
        self.prefill_chunk = prefill_chunk or self.scfg.prefill_chunk
        self._max_blocks = pages_for(self.max_len, self.page_size)
        if n_pages is None:
            n_pages = self.scfg.n_pages
        if not n_pages:  # full rectangle + null page: never preempts
            n_pages = self.n_slots * self._max_blocks + 1
        self.pages = init_kv_pages(self.cfg, n_pages, self.page_size,
                                   kv_bits=self.kv_bits, device=self.device)
        self.alloc = PageAllocator(n_pages, self.page_size, self.n_slots,
                                   self.max_len)
        self.sched = PagedScheduler(self.alloc, self.prefill_chunk)
        # the scheduler's own queue and lane table, under the names slots
        # mode gives its own
        self.queue, self.slot_req = self.sched.queue, self.sched.slot_req
        self.lanes = LaneTables(self.n_slots, self.device,
                                max_blocks=self._max_blocks,
                                chunk=self.prefill_chunk)
        params, pages, lanes = self.params, self.pages, self.lanes
        cfg, plan, abk = self.cfg, self.plan, self.attn_backend
        self._decode_paged = self._step_fn(lambda: decode_step_paged(
            params, pages, lanes.block_tables, lanes.pos, lanes.active,
            lanes.tokens, cfg, plan, attn_backend=abk))
        self._prefill_paged = self._step_fn(lambda: _prefill_chunk_fn(
            params, pages, lanes.block_tables, lanes.chunk_tokens,
            lanes.pos0, lanes.seq_lens, cfg, plan, attn_backend=abk))

    def _init_slots(self) -> None:
        self.cache = init_cache(self.cfg, self.n_slots, self.max_len,
                                device=self.device)
        self.queue: Deque[Request] = collections.deque()
        self.slot_req: List[Optional[Request]] = [None] * self.n_slots
        self.lanes = LaneTables(self.n_slots, self.device)
        params, cache, lanes = self.params, self.cache, self.lanes
        cfg, plan, abk = self.cfg, self.plan, self.attn_backend
        self._slots_step = self._step_fn(lambda: decode_step(
            params, cache, lanes.tokens, cfg, plan, attn_backend=abk,
            active=lanes.active)[0])

    def _step_fn(self, fn):
        """``fn`` as the engine runs it: a :class:`StepGraph` when graphs
        are on, else ``fn`` itself."""
        if not self.cuda_graphs:
            return fn
        graph = StepGraph(fn, pool=self._graph_pool)
        self._graphs.append(graph)
        return graph

    # ------------------------------------------------------------------ API
    def submit(self, prompt: List[int],
               max_new_tokens: Optional[int] = None) -> Request:
        """Enqueue a prompt; returns its :class:`Request`.  Raises
        ``ValueError`` for a malformed prompt and
        :class:`AdmissionRejected` when the bounded queue is full or the
        prompt can never fit the pool."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError(
                "empty prompt: submit at least one token (e.g. BOS)")
        if min(prompt) < 0 or max(prompt) >= self.cfg.vocab_size:
            bad = next(t for t in prompt
                       if t < 0 or t >= self.cfg.vocab_size)
            raise ValueError(
                f"prompt token {bad} outside the model vocabulary "
                f"[0, {self.cfg.vocab_size})")
        if len(prompt) > self.max_len - 2:
            raise ValueError(
                f"prompt of {len(prompt)} tokens cannot fit max_len="
                f"{self.max_len} with room to generate (limit is "
                f"max_len - 2 = {self.max_len - 2})")
        if self.scfg.max_queue and len(self.queue) >= self.scfg.max_queue:
            raise AdmissionRejected("queue_full")
        if (self.mode == "paged"
                and pages_for(len(prompt) + 1, self.page_size)
                > self.alloc.n_pages - 1):
            raise AdmissionRejected("pool_too_small")
        req = Request(self._next_rid, prompt,
                      self.scfg.max_new_tokens if max_new_tokens is None
                      else max_new_tokens)
        req.prefill_tokens = list(prompt)
        self._next_rid += 1
        self.queue.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def step(self) -> List[Request]:
        """One scheduler iteration (admit -> prefill -> decode token ->
        retire); returns the requests that finished this step."""
        if self.mode == "paged":
            self.sched.admit()
            self._prefill_once()
        else:
            self._admit()
        # pre-decode retire: max_new_tokens=0 must emit no tokens
        finished = self._retire(limit_only=True)
        if self.mode == "paged":
            self._decode_once_paged()
        else:
            self._decode_one()
        finished.extend(self._retire())
        return finished

    def run(self) -> List[Request]:
        """Drive until queue and lanes drain; returns completed requests."""
        finished: List[Request] = []
        while self.has_work():
            finished.extend(self.step())
        return finished

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Terminate a request now; in paged mode its pages are released
        at once.  Returns False if it had already finished."""
        if req.done or req.cancelled:
            return False
        req.cancelled = True
        req.finish_reason = reason
        for slot, r in enumerate(self.slot_req):
            if r is req:
                if self.mode == "paged":
                    self.alloc.free_slot(slot)
                self.slot_req[slot] = None
                return True
        if req in self.queue:
            self.queue.remove(req)
        return True

    @property
    def preemptions(self) -> int:
        return self.sched.preemptions if self.mode == "paged" else 0

    @property
    def capture_seconds(self) -> float:
        """Host seconds spent capturing this engine's CUDA graphs."""
        return sum(g.capture_seconds for g in self._graphs)

    # ============================================================ internals
    def _host_logits(self, logits: torch.Tensor) -> np.ndarray:
        return logits.float().cpu().numpy()  # host sync: the step landed

    def _timed(self, part: str, t0: float, captured: float) -> None:
        """Record a step that started at ``t0``, when the engine's captures
        had taken ``captured`` seconds: a capture made since goes to
        ``timings["capture"]`` and is left out of the step's time."""
        spent = time.perf_counter() - t0
        capture = self.capture_seconds - captured
        if capture:
            self.timings["capture"].append(capture)
        self.timings[part].append(spent - capture)

    def _prefill_once(self) -> None:
        """Advance every pending prompt by one batched chunk."""
        batch = self.sched.prefill_batch()
        if batch is None:
            return
        tokens, pos0, seq_lens, lanes = batch
        t0, captured = time.perf_counter(), self.capture_seconds
        self.lanes.load(block_tables=self.alloc.block_tables,
                        chunk_tokens=tokens, pos0=pos0, seq_lens=seq_lens)
        lg = self._host_logits(self._prefill_paged())
        self._timed("prefill", t0, captured)
        for slot, n_real in lanes:
            req = self.slot_req[slot]
            req.prefill_pos += n_real
            self.alloc.pos[slot] += n_real
            if req.prefill_pos >= len(req.prefill_tokens):
                req.last_logits = self._finite(req, lg[slot, -1])

    def _decode_once_paged(self) -> None:
        lanes = self.sched.decode_lanes()
        # page grant first (may preempt): a preempted lane drops out of
        # this step and resumes via re-prefill with identical greedy state
        ready = []
        for slot, req in lanes:
            if len(req.output) >= req.max_new_tokens:
                continue
            if self.slot_req[slot] is not req:
                continue  # preempted by an earlier lane's grant
            if self.sched.grant_decode_page(slot):
                ready.append((slot, req))
        ready = [(s, r) for s, r in ready if self.slot_req[s] is r]
        if not ready:
            return
        tokens = np.zeros((self.n_slots, 1), np.int32)
        for slot, req in ready:
            tok = self._sample_next(req)
            req.output.append(tok)
            tokens[slot, 0] = tok
        t0, captured = time.perf_counter(), self.capture_seconds
        self.lanes.load_tables(self.alloc)
        self.lanes.load(active=self._lane_mask(s for s, _ in ready),
                        tokens=tokens)
        lg = self._host_logits(self._decode_paged())
        self._timed("decode", t0, captured)
        for slot, req in ready:
            self.alloc.pos[slot] += 1
            req.last_logits = self._finite(req, lg[slot, -1])

    # ------------------------------------------------------ slots internals
    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                self.slot_req[slot] = req
                self._reset_slot(slot)
                self._prefill_slot(slot, req)

    def _reset_slot(self, slot: int) -> None:
        """Clear a slot's cache state before reuse: ``pos`` and the
        read-modify-write recurrent states (``conv`` / ``h``).  Stale K/V
        at positions up to ``pos`` is always overwritten before it is
        read, and positions beyond it are masked."""
        self.cache["pos"][slot] = 0
        for name in ("conv", "h"):
            if name in self.cache:
                self.cache[name][:, slot] = 0

    def _prefill_slot(self, slot: int, req: Request) -> None:
        """Prompt tokens enter the slot's cache by sequential decode, one
        slot at a time, as in the JAX package: one step a token with only
        this slot active, every other slot frozen.  The tokens reach the
        step's buffer by a copy on the device, so the loop never waits on
        the host until the last logits are read."""
        t0, captured = time.perf_counter(), self.capture_seconds
        prompt = torch.from_numpy(np.asarray(req.prompt, np.int32)).to(
            self.device)
        self.lanes.load(tokens=np.zeros((self.n_slots, 1), np.int32),
                        active=self._lane_mask([slot]))
        logits = None
        for i in range(len(req.prompt)):
            self.lanes.tokens[slot].copy_(prompt[i:i + 1])
            logits = self._slots_step()
        req.last_logits = self._finite(req, self._host_logits(logits)[slot,
                                                                       -1])
        self._timed("prefill", t0, captured)

    def _decode_one(self) -> None:
        updates: Dict[int, int] = {}
        for slot, req in enumerate(self.slot_req):
            if req is None or req.last_logits is None:
                continue
            if len(req.output) >= req.max_new_tokens:
                continue
            tok = self._sample_next(req)
            req.output.append(tok)
            updates[slot] = tok
        if not updates:
            return
        tokens = np.zeros((self.n_slots, 1), np.int32)
        for slot, tok in updates.items():
            tokens[slot, 0] = tok
        t0, captured = time.perf_counter(), self.capture_seconds
        self.lanes.load(tokens=tokens, active=self._lane_mask(updates))
        lg = self._host_logits(self._slots_step())
        self._timed("decode", t0, captured)
        for slot in updates:
            req = self.slot_req[slot]
            req.last_logits = self._finite(req, lg[slot, -1])

    # ------------------------------------------------------------- shared
    def _lane_mask(self, slots: Iterable[int]) -> np.ndarray:
        mask = np.zeros((self.n_slots,), bool)
        mask[list(slots)] = True
        return mask

    @staticmethod
    def _finite(req: Request, logits: np.ndarray) -> np.ndarray:
        if not np.all(np.isfinite(logits)):
            # per-request retry / quarantine is not ported yet: fail loudly
            raise FloatingPointError(
                f"non-finite logits for request {req.rid}")
        return logits

    def _retire(self, limit_only: bool = False) -> List[Request]:
        done = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self._should_retire(req, limit_only):
                req.done = True
                req.finish_reason = "length"
                done.append(req)
                if self.mode == "paged":
                    self.alloc.free_slot(slot)
                self.slot_req[slot] = None
        return done

    def _sample_next(self, req: Request) -> int:
        last = torch.from_numpy(np.asarray(req.last_logits))[None]
        return int(sample(last, self.generator, self.scfg.temperature,
                          self.scfg.top_k)[0])

    def _should_retire(self, req: Request, limit_only: bool) -> bool:
        limit = len(req.output) >= req.max_new_tokens
        if limit_only:
            return limit
        overflow = len(req.prompt) + len(req.output) >= self.max_len - 1
        return limit or overflow
