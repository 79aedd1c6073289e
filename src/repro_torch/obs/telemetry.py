"""The instrumentation surface the serving stack calls.

One :class:`Telemetry` object bundles the three observability pieces —
metrics registry, per-request span timelines, Chrome tracer — behind a
flat set of ``on_*`` hooks that the engine, scheduler, allocator and
prefix cache invoke at their transition points.  The hooks take plain
values (rids, counts, clock readings), never engine objects, so the obs
package depends on nothing in ``repro_torch.serve``.

:data:`NULL_TELEMETRY` is the disabled path: a singleton with the same
method surface where every hook is ``pass`` and every context manager
is a shared ``nullcontext``.  The serving stack calls hooks
unconditionally; with obs off, each call is one attribute lookup plus a
no-op invocation — no clocks read (``now()`` returns 0.0), no state
mutated anywhere.

No hook runs inside a captured serving step (``serve/step_graph.py``): a
CUDA graph would replay the step's kernels without them.  The engine
calls them around each replay and the host read of its logits, where the
JAX package calls them around its jitted dispatches.
"""

from __future__ import annotations

import contextlib
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.obs import clock as _clock
from repro_torch.obs import spans
from repro_torch.obs.costs import CostLedger, OpCost
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.spans import RequestTimeline
from repro_torch.obs.trace import (
    CACHE_TID,
    ENGINE_TID,
    MEM_TID,
    PAGES_TID,
    SCHED_TID,
    ChromeTracer,
)

_NULLCTX = contextlib.nullcontext()


class Telemetry:
    """Live instrumentation: registry + timelines + (optional) tracer.

    ``clock`` is injectable (defaults to the serve-path clock) so tests
    drive every timestamp manually.  ``trace=False`` keeps the metrics
    and timelines but skips Chrome-event collection;
    ``annotations=True`` additionally wraps each prefill / decode step
    (its replay and the host read of its logits) in a
    ``torch.profiler.record_function`` range, with ``<name>.launch`` (the
    step call) and ``<name>.wait`` (the logits read) inside it; without
    annotations no range opens.  Finished timelines are
    kept in a bounded deque (``max_timelines``) so week-long runs do not
    grow host memory.
    """

    enabled = True

    def __init__(self, clock=None, *, trace: bool = True,
                 annotations: bool = False, max_timelines: int = 1024):
        self.clock = clock or _clock.now
        self.registry = MetricsRegistry()
        self.tracer = ChromeTracer(self.clock) if trace else None
        self._annotations = annotations
        self.timelines: Dict[int, RequestTimeline] = {}
        self._finished: Deque[int] = deque()
        self._max_timelines = max_timelines
        self._step_n = 0
        self._n_slots = 0
        self.costs = CostLedger()
        self._last_pages = (0, 0, 0)  # (free, cached, evictable)
        # per-op (flops, bytes) counter pairs, resolved once: on_costs
        # runs on every prefill/decode dispatch and labeled registry
        # lookups are the hot part of the charge
        self._cost_counters: Dict[str, tuple] = {}
        # hot-path instruments resolved once: the per-token and per-step
        # hooks fire hundreds of times per serve and the create-or-return
        # registry lookup (label-key build + dict probes) costs more than
        # the inc/observe itself
        reg = self.registry
        self._c_tokens = reg.counter("serve_tokens_generated_total")
        self._c_steps = reg.counter("serve_steps_total")
        self._c_prefill_tokens = reg.counter("serve_prefill_tokens_total")
        self._h_step = reg.histogram("serve_step_s")
        self._h_tpot = reg.histogram("serve_tpot_s")
        self._h_ttft = reg.histogram("serve_ttft_s")
        self._h_prefill = reg.histogram("serve_prefill_chunk_s")
        self._h_decode = reg.histogram("serve_decode_step_s")
        self._g_pages = (reg.gauge("pages_free"), reg.gauge("pages_cached"),
                        reg.gauge("pages_evictable"))

    # ------------------------------------------------------------ plumbing
    def now(self) -> float:
        return self.clock()

    def attach_engine(self, n_slots: int, mode: str) -> None:
        """Label the trace tracks once the engine geometry is known."""
        self._n_slots = n_slots
        tr = self.tracer
        if tr is None:
            return
        tr.thread_name(ENGINE_TID, f"engine.step ({mode})")
        for s in range(n_slots):
            tr.thread_name(1 + s, f"lane {s}")
        tr.thread_name(SCHED_TID, "scheduler")
        tr.thread_name(CACHE_TID, "prefix-cache")
        tr.thread_name(PAGES_TID, "pages")
        tr.thread_name(MEM_TID, "memory")

    def _timeline(self, rid: int) -> Optional[RequestTimeline]:
        return self.timelines.get(rid)

    def _finish(self, rid: int) -> None:
        self._finished.append(rid)
        while len(self.timelines) > self._max_timelines and self._finished:
            self.timelines.pop(self._finished.popleft(), None)

    # --------------------------------------------------------- step framing
    def step_begin(self) -> None:
        self._step_n += 1
        if self.tracer is not None:
            self.tracer.begin(ENGINE_TID, "step",
                              args={"n": self._step_n})

    def step_end(self, t0: float) -> None:
        t1 = self.clock()
        self._c_steps.inc()
        self._h_step.observe(t1 - t0)
        if self.tracer is not None:
            # sample pool occupancy into the "memory" track once per step
            free, cached, evictable = self._last_pages
            self.tracer.counter(MEM_TID, "memory",
                                {"free": free, "cached": cached,
                                 "evictable": evictable})
            self.tracer.end(ENGINE_TID, "step", t=t1)

    def phase(self, name: str):
        """Span a step phase (admit/prefill/decode) on the engine track."""
        if self.tracer is None:
            return _NULLCTX
        return self._phase_ctx(name)

    @contextlib.contextmanager
    def _phase_ctx(self, name: str):
        self.tracer.begin(ENGINE_TID, name)
        try:
            yield
        finally:
            self.tracer.end(ENGINE_TID, name)

    def annotate(self, name: str):
        """A ``torch.profiler.record_function`` range (no-op unless
        enabled)."""
        if self._annotations:
            return torch.profiler.record_function(name)
        return _NULLCTX

    # ----------------------------------------------------- request lifecycle
    def on_submit(self, rid: int, prompt_len: int, t: float) -> None:
        self.registry.counter("serve_requests_submitted_total").inc()
        self.registry.counter("serve_prompt_tokens_total").inc(prompt_len)
        self.timelines[rid] = RequestTimeline(rid, t)

    def on_shed(self, reason: str) -> None:
        # refused before a Request exists: no rid, no timeline — count by
        # reason and mark the scheduler track
        self.registry.counter("serve_requests_shed_total",
                              reason=reason).inc()
        if self.tracer is not None:
            self.tracer.instant(SCHED_TID, "shed", args={"reason": reason})

    def on_admit(self, rid: int, slot: int, cached_tokens: int) -> None:
        t = self.clock()
        self.registry.counter("serve_admissions_total").inc()
        tl = self._timeline(rid)
        if tl is not None:
            if tl.first(spans.ADMITTED) is None:
                self.registry.histogram("serve_queue_wait_s").observe(
                    t - tl.submit_t)
            tl.transition(spans.ADMITTED, t)
            tl.transition(spans.PREFILLING, t)
            tl.cached_tokens = max(tl.cached_tokens, cached_tokens)
        if self.tracer is not None:
            self.tracer.instant(
                SCHED_TID, "admit",
                args={"rid": rid, "slot": slot,
                      "cached_tokens": cached_tokens})

    def on_preempt(self, rid: int, slot: int) -> None:
        t = self.clock()
        self.registry.counter("serve_preemptions_total").inc()
        tl = self._timeline(rid)
        if tl is not None:
            tl.transition(spans.PREEMPTED, t)
        if self.tracer is not None:
            self.tracer.instant(SCHED_TID, "preempt",
                                args={"rid": rid, "slot": slot})

    def on_prefill(self, lanes: List[Tuple[int, int, int]],
                   t0: float) -> None:
        """One batched chunked-prefill dispatch landed.

        ``lanes``: ``(slot, rid, n_tokens)`` per participating lane;
        ``t0``: clock reading just before dispatch.
        """
        t1 = self.clock()
        n_total = sum(n for _, _, n in lanes)
        self._c_prefill_tokens.inc(n_total)
        self._h_prefill.observe(t1 - t0)
        for slot, rid, n in lanes:
            tl = self._timeline(rid)
            if tl is not None:
                tl.prefill_spans.append((t0, t1, n))
            if self.tracer is not None:
                self.tracer.complete(1 + slot, "prefill", t0, t1,
                                     args={"rid": rid, "tokens": n})

    def on_decode(self, lanes: List[Tuple[int, int]], t0: float) -> None:
        """One batched decode-step dispatch landed (``(slot, rid)``)."""
        t1 = self.clock()
        self._h_decode.observe(t1 - t0)
        if self.tracer is not None:
            for slot, rid in lanes:
                self.tracer.complete(1 + slot, "decode", t0, t1,
                                     args={"rid": rid})

    def on_first_token(self, rid: int, ttft_s: float, t: float) -> None:
        self._h_ttft.observe(ttft_s)
        self._c_tokens.inc()
        tl = self._timeline(rid)
        if tl is not None:
            tl.transition(spans.DECODING, t)
            tl.token(t)

    def on_token(self, rid: int, t: float) -> None:
        self._c_tokens.inc()
        tl = self._timeline(rid)
        if tl is not None:
            if tl.last_token_t is not None:
                self._h_tpot.observe(t - tl.last_token_t)
            tl.token(t)

    def on_retire(self, rid: int, reason: str, n_out: int) -> None:
        t = self.clock()
        self.registry.counter("serve_requests_retired_total",
                              reason=reason).inc()
        tl = self._timeline(rid)
        if tl is not None:
            tl.transition(spans.RETIRED, t)
            self.registry.histogram("serve_e2e_s").observe(t - tl.submit_t)
            self._finish(rid)
        if self.tracer is not None:
            self.tracer.instant(SCHED_TID, "retire",
                                args={"rid": rid, "tokens": n_out})

    def on_cancel(self, rid: int, reason: str) -> None:
        t = self.clock()
        self.registry.counter("serve_requests_cancelled_total",
                              reason=reason).inc()
        tl = self._timeline(rid)
        if tl is not None:
            tl.transition(spans.TIMED_OUT if reason == "timed_out"
                          else spans.CANCELLED, t)
            self._finish(rid)
        if self.tracer is not None:
            self.tracer.instant(SCHED_TID, "cancel",
                                args={"rid": rid, "reason": reason})

    # --------------------------------------------------- faults / robustness
    def on_fault(self, rid: int, kind: str) -> None:
        """A per-request fault was detected (``kind``: ``step_fault`` /
        ``nan_logits``) — before the retry-vs-quarantine decision."""
        self.registry.counter("serve_faults_total", kind=kind).inc()
        if self.tracer is not None:
            self.tracer.instant(SCHED_TID, "fault",
                                args={"rid": rid, "kind": kind})

    def on_retry(self, rid: int, kind: str, attempt: int) -> None:
        """A faulted request was requeued for a recompute-style retry."""
        t = self.clock()
        self.registry.counter("serve_retries_total", kind=kind).inc()
        # everything charged to the request so far will be recomputed
        self.costs.mark_retry(rid)
        tl = self._timeline(rid)
        if tl is not None:
            # like preemption, a retry loops the request back to QUEUED
            tl.transition(spans.PREEMPTED, t)
        if self.tracer is not None:
            self.tracer.instant(SCHED_TID, "retry",
                                args={"rid": rid, "kind": kind,
                                      "attempt": attempt})

    def on_quarantine(self, rid: int, kind: str, n_out: int) -> None:
        """A request exhausted its retry budget and was quarantined
        (``finish_reason="error"``)."""
        t = self.clock()
        self.registry.counter("serve_requests_quarantined_total",
                              kind=kind).inc()
        tl = self._timeline(rid)
        if tl is not None:
            tl.transition(spans.ERRORED, t)
            self._finish(rid)
        if self.tracer is not None:
            self.tracer.instant(SCHED_TID, "quarantine",
                                args={"rid": rid, "kind": kind,
                                      "tokens": n_out})

    def on_audit(self, level: int, ok: bool) -> None:
        """One invariant audit pass completed (``ok=False`` means it
        raised — counted before the AuditError propagates)."""
        self.registry.counter("serve_audits_total").inc()
        if not ok:
            self.registry.counter("serve_audit_failures_total").inc()

    def on_chaos(self, site: str) -> None:
        """The chaos injector fired a fault at ``site``."""
        self.registry.counter("serve_chaos_injected_total", site=site).inc()
        if self.tracer is not None:
            self.tracer.instant(SCHED_TID, "chaos", args={"site": site})

    def on_frontend_shed(self, reason: str) -> None:
        """The streaming front-end shed a submission (by reason)."""
        self.registry.counter("frontend_shed_total", reason=reason).inc()

    def on_frontend_timeout(self) -> None:
        """The front-end's deadline sweep timed out a live stream."""
        self.registry.counter("frontend_timeouts_total").inc()

    # -------------------------------------------------- prefix cache / pages
    def on_cache_hit(self, rid: int, tokens: int, cow: bool) -> None:
        self.registry.counter("prefix_cache_hits_total").inc()
        self.registry.counter("prefix_cache_hit_tokens_total").inc(tokens)
        if cow:
            self.registry.counter("prefix_cache_cow_forks_total").inc()
        if self.tracer is not None:
            self.tracer.instant(
                CACHE_TID, "hit",
                args={"rid": rid, "tokens": tokens, "cow": cow})

    def on_cache_miss(self, rid: int) -> None:
        self.registry.counter("prefix_cache_misses_total").inc()
        if self.tracer is not None:
            self.tracer.instant(CACHE_TID, "miss", args={"rid": rid})

    def on_cache_insert(self, n_pages: int) -> None:
        self.registry.counter("prefix_cache_inserted_pages_total").inc(
            n_pages)
        if self.tracer is not None:
            self.tracer.instant(CACHE_TID, "insert",
                                args={"pages": n_pages})

    def on_cache_evict(self, n_pages: int) -> None:
        self.registry.counter("prefix_cache_evicted_pages_total").inc(
            n_pages)
        if self.tracer is not None:
            self.tracer.instant(CACHE_TID, "evict",
                                args={"pages": n_pages})

    def on_pages(self, free: int, cached: int = 0,
                 evictable: int = 0) -> None:
        g_free, g_cached, g_evictable = self._g_pages
        g_free.set(free)
        g_cached.set(cached)
        g_evictable.set(evictable)
        self._last_pages = (free, cached, evictable)
        if self.tracer is not None:
            self.tracer.counter(PAGES_TID, "pages",
                                {"free": free, "cached": cached,
                                 "evictable": evictable})

    # ------------------------------------------------------------ cost ledger
    def on_costs(self, op_costs: Dict[str, OpCost], rids=()) -> None:
        """Charge one dispatch's analytic op→cost table (see
        ``repro_torch.obs.costs``) to the ledger, attributed evenly across the
        participating requests, and mirror per-op totals into the
        registry."""
        self.costs.charge(op_costs, rids)
        cache = self._cost_counters
        for op, c in op_costs.items():
            pair = cache.get(op)
            if pair is None:
                pair = cache[op] = (
                    self.registry.counter("serve_cost_flops_total", op=op),
                    self.registry.counter("serve_cost_bytes_total", op=op))
            pair[0].inc(c.flops)
            pair[1].inc(c.bytes)

    # ---------------------------------------------------- snapshot / restore
    def on_restore(self, rids, t: Optional[float] = None) -> None:
        """Requests were restored mid-flight from a snapshot: any stale
        non-terminal timeline for a restored rid is discarded and a fresh
        one opened — restored requests must never dangle in a live span
        state they can no longer leave."""
        t = self.clock() if t is None else t
        rids = list(rids)
        for rid in rids:
            self.registry.counter("serve_requests_restored_total").inc()
            self.timelines[rid] = RequestTimeline(rid, t)
        if self.tracer is not None:
            self.tracer.instant(SCHED_TID, "restore",
                                args={"restored": len(rids)})

    def close_open_timelines(self, state: str = spans.ERRORED,
                             t: Optional[float] = None) -> int:
        """Force every non-terminal timeline into ``state`` (default
        ``errored``).  For engines abandoned mid-flight — killed before a
        snapshot restore, or shut down with requests in flight — so no
        span dangles in a live state.  Returns the number closed."""
        t = self.clock() if t is None else t
        closed = 0
        # _finish may evict over-cap rows from self.timelines: snapshot
        for rid, tl in list(self.timelines.items()):
            if tl.state not in spans.TERMINAL:
                tl.transition(state, t)
                self._finish(rid)
                closed += 1
        return closed

    # -------------------------------------------------------------- outputs
    def snapshot(self) -> Dict:
        """The structured snapshot ``ServeEngine.metrics()`` embeds."""
        states: Dict[str, int] = {}
        for tl in self.timelines.values():
            states[tl.state] = states.get(tl.state, 0) + 1
        return {
            "steps": self._step_n,
            "request_states": states,
            "metrics": self.registry.to_dict(),
            "costs": self.costs.snapshot(),
        }

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()

    def export_chrome_trace(self, path: str) -> Optional[str]:
        """Write the Chrome trace JSON; None when tracing is off."""
        if self.tracer is None:
            return None
        return self.tracer.write(path)


class NullTelemetry:
    """The disabled path: same surface, every hook a no-op.

    No registry, no tracer, no timelines, no clock reads — constructing
    engines with obs off costs one shared singleton reference, and every
    instrumentation call site costs an attribute lookup plus an empty
    call.
    """

    enabled = False
    registry = None
    tracer = None
    costs = None
    timelines: Dict[int, RequestTimeline] = {}

    def now(self) -> float:
        return 0.0

    def attach_engine(self, n_slots, mode):
        pass

    def step_begin(self):
        pass

    def step_end(self, t0):
        pass

    def phase(self, name):
        return _NULLCTX

    def annotate(self, name):
        return _NULLCTX

    def on_submit(self, rid, prompt_len, t):
        pass

    def on_shed(self, reason):
        pass

    def on_admit(self, rid, slot, cached_tokens):
        pass

    def on_preempt(self, rid, slot):
        pass

    def on_prefill(self, lanes, t0):
        pass

    def on_decode(self, lanes, t0):
        pass

    def on_first_token(self, rid, ttft_s, t):
        pass

    def on_token(self, rid, t):
        pass

    def on_retire(self, rid, reason, n_out):
        pass

    def on_cancel(self, rid, reason):
        pass

    def on_fault(self, rid, kind):
        pass

    def on_retry(self, rid, kind, attempt):
        pass

    def on_quarantine(self, rid, kind, n_out):
        pass

    def on_audit(self, level, ok):
        pass

    def on_chaos(self, site):
        pass

    def on_frontend_shed(self, reason):
        pass

    def on_frontend_timeout(self):
        pass

    def on_cache_hit(self, rid, tokens, cow):
        pass

    def on_cache_miss(self, rid):
        pass

    def on_cache_insert(self, n_pages):
        pass

    def on_cache_evict(self, n_pages):
        pass

    def on_pages(self, free, cached=0, evictable=0):
        pass

    def on_costs(self, op_costs, rids=()):
        pass

    def on_restore(self, rids, t=None):
        pass

    def close_open_timelines(self, state=None, t=None):
        return 0

    def snapshot(self) -> Dict:
        return {}

    def prometheus_text(self) -> str:
        return ""

    def export_chrome_trace(self, path) -> Optional[str]:
        return None


NULL_TELEMETRY = NullTelemetry()
