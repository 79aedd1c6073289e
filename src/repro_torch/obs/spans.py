"""Per-request span timelines: every lifecycle transition, timestamped.

A :class:`RequestTimeline` is the observability twin of a
``repro_torch.serve.engine.Request``: the engine/scheduler stamp each transition
through the telemetry layer and the timeline accumulates them as
``(state, t)`` events, from which the *correct* per-request latency
decomposition falls out:

* ``queue_wait`` — submit → first admission;
* ``ttft``       — submit → first emitted token (per request, **not**
  relative to the engine's run start);
* ``tpot``       — mean inter-token gap after the first token;
* ``e2e``        — submit → terminal state.

State machine (terminal states in caps)::

    submitted -> queued -> admitted -> prefilling -> decoding -> RETIRED
                   ^           |            |            |   \\-> CANCELLED
                   |           +------------+------------+   \\-> TIMED_OUT
                   +------ preempted (pages reclaimed, re-queued)

Preemption loops back: a preempted request re-enters ``queued`` and is
re-admitted later; its timeline keeps every pass, so preemption cost is
visible per request (``n_preemptions``, time spent re-prefilling).
Shed requests never get a timeline — they are refused before a
``Request`` (and thus an rid) exists; the registry counts them by
reason and the tracer drops an instant on the scheduler track.

Timestamps come from the telemetry's injectable clock, so tests drive
transitions deterministically with a manual clock.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# canonical state names (timeline events and Chrome-trace args use these)
SUBMITTED = "submitted"
QUEUED = "queued"
ADMITTED = "admitted"
PREFILLING = "prefilling"
DECODING = "decoding"
PREEMPTED = "preempted"
RETIRED = "retired"
CANCELLED = "cancelled"
TIMED_OUT = "timed_out"
# quarantined after a step fault / non-finite logits exhausted the
# request's retry budget (finish_reason="error"); like PREEMPTED, a
# *retried* fault is not terminal — the request loops back to QUEUED
ERRORED = "errored"

TERMINAL = (RETIRED, CANCELLED, TIMED_OUT, ERRORED)


class RequestTimeline:
    """One request's timestamped lifecycle (host-side, bounded).

    ``events`` holds every ``(state, t)`` transition in order;
    ``prefill_spans`` the per-chunk ``(t0, t1, n_tokens)`` work spans.
    Token *times* are not stored per token (unbounded); instead the
    owning telemetry folds inter-token gaps into its ``serve_tpot_s``
    histogram and the timeline keeps first/last token plus the count.
    """

    __slots__ = ("rid", "submit_t", "events", "prefill_spans",
                 "first_token_t", "last_token_t", "n_tokens", "end_t",
                 "n_preemptions", "cached_tokens")

    def __init__(self, rid: int, submit_t: float):
        self.rid = rid
        self.submit_t = submit_t
        self.events: List[Tuple[str, float]] = [(SUBMITTED, submit_t),
                                                (QUEUED, submit_t)]
        self.prefill_spans: List[Tuple[float, float, int]] = []
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.n_tokens = 0
        self.end_t: Optional[float] = None
        self.n_preemptions = 0
        self.cached_tokens = 0

    # ------------------------------------------------------------ recording
    def transition(self, state: str, t: float) -> None:
        self.events.append((state, t))
        if state == PREEMPTED:
            self.n_preemptions += 1
            self.events.append((QUEUED, t))
        if state in TERMINAL:
            self.end_t = t

    def token(self, t: float) -> None:
        if self.first_token_t is None:
            self.first_token_t = t
        self.last_token_t = t
        self.n_tokens += 1

    # --------------------------------------------------------------- views
    @property
    def state(self) -> str:
        return self.events[-1][0]

    @property
    def finished(self) -> bool:
        return self.state in TERMINAL

    def first(self, state: str) -> Optional[float]:
        for s, t in self.events:
            if s == state:
                return t
        return None

    @property
    def queue_wait(self) -> Optional[float]:
        t = self.first(ADMITTED)
        return None if t is None else t - self.submit_t

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def tpot(self) -> Optional[float]:
        if self.n_tokens < 2:
            return None
        return ((self.last_token_t - self.first_token_t)
                / (self.n_tokens - 1))

    @property
    def e2e(self) -> Optional[float]:
        return None if self.end_t is None else self.end_t - self.submit_t

    def prefill_tokens_computed(self) -> int:
        return sum(n for _, _, n in self.prefill_spans)

    def to_dict(self) -> Dict:
        return {
            "rid": self.rid,
            "state": self.state,
            "events": [(s, round(t, 6)) for s, t in self.events],
            "prefill_spans": [
                (round(t0, 6), round(t1, 6), n)
                for t0, t1, n in self.prefill_spans],
            "n_tokens": self.n_tokens,
            "n_preemptions": self.n_preemptions,
            "cached_tokens": self.cached_tokens,
            "queue_wait_s": self.queue_wait,
            "ttft_s": self.ttft,
            "tpot_s": self.tpot,
            "e2e_s": self.e2e,
        }
