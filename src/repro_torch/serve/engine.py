"""Paged-KV continuous-batching serving engine.

KV state lives in a shared page pool (:mod:`repro_torch.serve.pages`)
addressed through per-request block tables; the FCFS scheduler
(:mod:`repro_torch.serve.scheduler`) admits requests by page capacity,
prefills prompts in batched chunks through ``prefill_chunk`` (one forward
per chunk across all pending lanes), decodes one token per step for every
ready lane, and preempts the longest-running request when pages run out.

Every linear runs through one :class:`~repro_torch.engine.EnginePlan`
resolved at construction; with ``EngineConfig.kv_bits = 8`` the pools are
int8.  On a CUDA device the plan's ``auto`` backends are the hand-written
kernels (GEMV and paged attention); on the CPU they are the plain PyTorch
paths.

Not ported yet, and refused at construction rather than ignored: the
fixed-slot mode, the prefix cache, the budget scheduler, runtime audits
and per-request retry / quarantine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ServeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import resolve_attn_backend, resolve_plan
from repro_torch.models.transformer import (
    decode_step_paged,
    prefill_chunk as _prefill_chunk_fn,
    quantize_params,
)
from repro_torch.serve.pages import PageAllocator, init_kv_pages, pages_for
from repro_torch.serve.sampler import sample
from repro_torch.serve.scheduler import PagedScheduler


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
    missing = []
    if scfg.mode == "slots":
        missing.append("mode='slots'")
    if scfg.prefix_cache:
        missing.append("prefix_cache")
    if scfg.sched != "fcfs":
        missing.append(f"sched={scfg.sched!r}")
    if scfg.audit:
        missing.append("audit")
    return missing


class ServeEngine:
    """Continuous-batching serving over a paged KV cache.

    ``device``: where the model runs; None means the GPU, and raises on a
    host without one.  ``params`` are quantized at construction when the
    plan packs weights.  ``page_size`` / ``n_pages`` / ``prefill_chunk``
    default to the :class:`ServeConfig`'s; ``n_pages=0`` sizes the pool to
    the full ``n_slots × max_len`` rectangle (never preempts).
    ``attn_backend`` (``gather`` / ``cuda``) overrides the plan's.

    ``timings`` records the host-clock seconds of every prefill chunk and
    decode step, each measured up to the host sync that reads its logits.
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
        page_size: Optional[int] = None,
        n_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        attn_backend: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.scfg = scfg or ServeConfig()
        missing = _not_ported(self.scfg)
        if missing:
            raise NotImplementedError(
                f"not ported yet: {', '.join(missing)}")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"serving family {cfg.family!r} is not ported yet")
        self.device = resolve_device(device)
        self.mode = "paged"
        # the EngineConfig is resolved into an EnginePlan exactly once
        self.plan = resolve_plan(self.scfg.engine, device=self.device)
        if self.plan is not None and self.plan.bits:
            params = quantize_params(params, cfg, self.plan.bits)
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.generator = torch.Generator().manual_seed(seed)
        self.kv_bits = self.plan.kv_bits if self.plan is not None else 0
        self.attn_backend = resolve_attn_backend(
            attn_backend
            or (self.plan.attn_backend if self.plan is not None
                else self.scfg.engine.attn_backend),
            self.device)
        self._next_rid = 0
        self.timings: Dict[str, List[float]] = {"prefill": [], "decode": []}

        self.page_size = page_size or self.scfg.page_size
        self.prefill_chunk = prefill_chunk or self.scfg.prefill_chunk
        self._max_blocks = pages_for(max_len, self.page_size)
        if n_pages is None:
            n_pages = self.scfg.n_pages
        if not n_pages:  # full rectangle + null page: never preempts
            n_pages = n_slots * self._max_blocks + 1
        self.pages = init_kv_pages(cfg, n_pages, self.page_size,
                                   kv_bits=self.kv_bits, device=self.device)
        self.alloc = PageAllocator(n_pages, self.page_size, n_slots, max_len)
        self.sched = PagedScheduler(self.alloc, self.prefill_chunk)

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
        if self.scfg.max_queue and len(self.sched.queue) >= self.scfg.max_queue:
            raise AdmissionRejected("queue_full")
        if (pages_for(len(prompt) + 1, self.page_size)
                > self.alloc.n_pages - 1):
            raise AdmissionRejected("pool_too_small")
        req = Request(self._next_rid, prompt,
                      self.scfg.max_new_tokens if max_new_tokens is None
                      else max_new_tokens)
        req.prefill_tokens = list(prompt)
        self._next_rid += 1
        self.sched.submit(req)
        return req

    def has_work(self) -> bool:
        return self.sched.has_work()

    def step(self) -> List[Request]:
        """One scheduler iteration (admit -> prefill chunk -> decode token
        -> retire); returns the requests that finished this step."""
        self.sched.admit()
        self._prefill_once()
        # pre-decode retire: max_new_tokens=0 must emit no tokens
        finished = self._retire_paged(limit_only=True)
        self._decode_once_paged()
        finished.extend(self._retire_paged())
        return finished

    def run(self) -> List[Request]:
        """Drive until queue and lanes drain; returns completed requests."""
        finished: List[Request] = []
        while self.has_work():
            finished.extend(self.step())
        return finished

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Terminate a request now; its pages are released at once.
        Returns False if it had already finished."""
        if req.done or req.cancelled:
            return False
        req.cancelled = True
        req.finish_reason = reason
        for slot, r in enumerate(self.sched.slot_req):
            if r is req:
                self.alloc.free_slot(slot)
                self.sched.slot_req[slot] = None
                return True
        if req in self.sched.queue:
            self.sched.queue.remove(req)
        return True

    @property
    def preemptions(self) -> int:
        return self.sched.preemptions

    # ============================================================ internals
    def _host_logits(self, logits: torch.Tensor) -> np.ndarray:
        return logits.float().cpu().numpy()  # host sync: the step landed

    def _prefill_once(self) -> None:
        """Advance every pending prompt by one batched chunk."""
        batch = self.sched.prefill_batch()
        if batch is None:
            return
        tokens, pos0, seq_lens, lanes = batch
        t0 = time.perf_counter()
        bt, _ = self.alloc.device_tables(self.device)
        logits = _prefill_chunk_fn(
            self.params, self.pages, bt,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pos0).to(self.device),
            torch.from_numpy(seq_lens).to(self.device),
            self.cfg, self.plan, attn_backend=self.attn_backend)
        lg = self._host_logits(logits)
        self.timings["prefill"].append(time.perf_counter() - t0)
        for slot, n_real in lanes:
            req = self.sched.slot_req[slot]
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
            if self.sched.slot_req[slot] is not req:
                continue  # preempted by an earlier lane's grant
            if self.sched.grant_decode_page(slot):
                ready.append((slot, req))
        ready = [(s, r) for s, r in ready if self.sched.slot_req[s] is r]
        if not ready:
            return
        tokens = np.zeros((self.n_slots, 1), np.int32)
        for slot, req in ready:
            tok = self._sample_next(req)
            req.output.append(tok)
            tokens[slot, 0] = tok
        active = self.sched.lane_mask(s for s, _ in ready)
        t0 = time.perf_counter()
        bt, pos = self.alloc.device_tables(self.device)
        logits = decode_step_paged(
            self.params, self.pages, bt, pos,
            torch.from_numpy(active).to(self.device),
            torch.from_numpy(tokens).to(self.device),
            self.cfg, self.plan, attn_backend=self.attn_backend)
        lg = self._host_logits(logits)
        self.timings["decode"].append(time.perf_counter() - t0)
        for slot, req in ready:
            self.alloc.pos[slot] += 1
            req.last_logits = self._finite(req, lg[slot, -1])

    @staticmethod
    def _finite(req: Request, logits: np.ndarray) -> np.ndarray:
        if not np.all(np.isfinite(logits)):
            # per-request retry / quarantine is not ported yet: fail loudly
            raise FloatingPointError(
                f"non-finite logits for request {req.rid}")
        return logits

    def _retire_paged(self, limit_only: bool = False) -> List[Request]:
        done = []
        for slot, req in enumerate(self.sched.slot_req):
            if req is None:
                continue
            if self._should_retire(req, limit_only):
                req.done = True
                req.finish_reason = "length"
                done.append(req)
                self.alloc.free_slot(slot)
                self.sched.slot_req[slot] = None
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
