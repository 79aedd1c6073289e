"""Deterministic chaos injection for the *serving* path.

``repro_torch.ft.failures`` gives a step loop a seeded failure drill;
this module is the serving analogue.  At production scale faults are
routine traffic — a page grant fails, a device step errors, a logit
goes non-finite, a tenant cancels ten thousand streams at once — and
the serve stack must degrade per-request, never per-process.  The
:class:`ChaosInjector` makes those faults *first-class, replayable
inputs*: every hook site in the stack asks ``chaos.fire(site)`` at its
decision point, and the injector answers deterministically from either
an explicit **schedule** (fire at the nth check of a site) or a seeded
**rate** (an independent pseudo-random draw per check, keyed by
``(seed, site, check_index)`` so the answer does not depend on thread
timing or call interleaving across sites).

Hook sites (the ``SITES`` tuple; each named constant documents where
the stack consults it):

* ``page_grant``   — ``PageAllocator._take_page``: the pop fails as if
  the pool were exhausted (admission blocks / decode preempts — the
  normal dry-pool paths, exercised on demand).
* ``step_fault``   — ``ServeEngine`` prefill/decode dispatch: one
  participating lane takes a :class:`SimulatedStepFailure` (the
  serving analogue of ``SimulatedNodeFailure``).
* ``nan_logits``   — ``ServeEngine`` after a dispatch lands: one
  lane's fresh logits are overwritten with NaN, exercising the
  non-finite quarantine path end to end.
* ``preempt_storm``— ``ServeEngine`` step: every resident request is
  preempted at once (recompute-style, token-preserving).
* ``cancel``       — ``ServeFrontend.step``: one live stream is
  cancelled (a client hanging up mid-generation).
* ``deadline_skew``— ``ServeFrontend.step``: the deadline sweep sees a
  skewed clock (``skew_s`` into the future), firing timeouts early.

Every fired event is appended to ``self.log`` as ``(site, index)``, so
a drill can assert that two runs with the same seed injected the exact
same faults — determinism is what makes a chaos failure *debuggable*.
The decisions are the JAX package's (``repro.ft.chaos``): the same
seed, rates and schedule fire the same faults at the same checks and
pick the same victims in both packages.
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Tuple

# hook sites, in stack order (allocator -> engine -> scheduler -> frontend)
PAGE_GRANT = "page_grant"
STEP_FAULT = "step_fault"
NAN_LOGITS = "nan_logits"
PREEMPT_STORM = "preempt_storm"
CANCEL = "cancel"
DEADLINE_SKEW = "deadline_skew"

SITES = (PAGE_GRANT, STEP_FAULT, NAN_LOGITS, PREEMPT_STORM, CANCEL,
         DEADLINE_SKEW)


class SimulatedStepFailure(RuntimeError):
    """A serving step failed for one lane (injected device error)."""

    def __init__(self, slot: int, rid: int):
        super().__init__(f"simulated step failure: lane {slot} rid {rid}")
        self.slot = slot
        self.rid = rid


class ChaosInjector:
    """Seeded / scheduled fault source for the serving stack.

    ``schedule``: ``{site: iterable of check indices}`` — the site
    fires exactly at those occurrences of its check (0-based: the
    first ``fire(site)`` call is check 0).  ``rates``: ``{site:
    probability}`` — each check draws independently from a generator
    seeded by ``(seed, site, check_index)``.  A site may appear in
    both; the schedule fires first (no double-count).  ``skew_s`` is
    the clock skew applied when ``deadline_skew`` fires.

    The injector is single-run state (check counters, fired log);
    build a fresh one with the same arguments to replay a run.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 schedule: Optional[Dict[str, Iterable[int]]] = None,
                 skew_s: float = 0.0):
        self.seed = seed
        self.rates = dict(rates or {})
        self.schedule = {site: set(idx) for site, idx
                         in (schedule or {}).items()}
        self.skew_s = skew_s
        for site in list(self.rates) + list(self.schedule):
            if site not in SITES:
                raise ValueError(
                    f"unknown chaos site {site!r}; choose from {SITES}")
        self._counts: Dict[str, int] = {}
        self.log: List[Tuple[str, int]] = []
        # observability sink: the owning engine points this at its
        # telemetry (ServeEngine sets chaos.obs = self.obs) so every
        # fired fault — including allocator-internal sites like
        # ``page_grant`` — lands in the metrics registry without each
        # call site having to report separately.  None = unobserved.
        self.obs = None

    # ------------------------------------------------------------ decisions
    def _rng(self, site: str, idx: int, salt: str = "") -> random.Random:
        # string seeds hash through sha512 — stable across processes
        # (tuple seeds go through hash(), which PYTHONHASHSEED perturbs)
        return random.Random(f"{self.seed}/{site}/{idx}/{salt}")

    def count(self, site: str) -> int:
        """How many times ``site`` has been checked so far."""
        return self._counts.get(site, 0)

    def fire(self, site: str) -> bool:
        """One check of ``site``: does the fault fire now?

        Deterministic in ``(seed, site, check index)`` only — the
        answer is independent of what any other site did, so a run
        replays exactly even when the stack's call order across sites
        shifts (e.g. an earlier fault changes how many lanes decode).
        """
        if site not in SITES:
            raise ValueError(
                f"unknown chaos site {site!r}; choose from {SITES}")
        idx = self._counts.get(site, 0)
        self._counts[site] = idx + 1
        fired = idx in self.schedule.get(site, ())
        if not fired:
            rate = self.rates.get(site, 0.0)
            if rate > 0.0:
                fired = self._rng(site, idx).random() < rate
        if fired:
            self.log.append((site, idx))
            if self.obs is not None:
                self.obs.on_chaos(site)
        return fired

    def pick(self, site: str, n: int) -> int:
        """Deterministic victim index in ``[0, n)`` for the fault that
        just fired at ``site`` (keyed by the *fired* check index, so a
        replay picks the same victim)."""
        if n <= 0:
            raise ValueError("pick() needs a non-empty victim set")
        idx = self._counts.get(site, 1) - 1
        return self._rng(site, idx, "pick").randrange(n)

    # ------------------------------------------------------------- reports
    def fired(self, site: Optional[str] = None) -> int:
        """Total faults fired (for ``site``, or overall)."""
        if site is None:
            return len(self.log)
        return sum(1 for s, _ in self.log if s == site)

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s, _ in self.log:
            out[s] = out.get(s, 0) + 1
        return out
