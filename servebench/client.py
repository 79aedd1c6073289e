"""The client side of a run: submits the traffic to the engine between
steps and stamps what comes back on the host clock.

``Client.step`` runs one ``ServeEngine.step()``, which ends in the
engine's host sync on the logits, then stamps each token that the step
appended to a request's output with the clock read after it.  A step's
record says whether it ran a prefill chunk and a decode step (from the
engine's ``timings``), the prompt rows it computed (the scheduler's
``prefill_computed``), the experts its decode part touched (the moe
family's ``experts_touched["decode"]``) and, a request at a time, the
positions of the prompt tokens it computed and of the token each
decoding lane fed, which the metric readers price.

The client also keeps some of the logits the engine handed back, for the
check: each request's logits at its last prompt position (as the chunk
step that finished its prompt left them, read before that step's decode
takes its first token) and, each step, one decoding request's logits in
turn, into a float32 table that set-up allocates and touches
(``LOGIT_ROWS`` rows).  The copy is numpy's: a torch copy on the host cost
a host-bound cell a few percent of its rate on the card, numpy's nothing
that showed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from servebench.traffic import Spec, Traffic

# rows of the program's logits kept a run: a decode step keeps one, a
# finished prompt one; set-up and a 36 s window of the cells keep under
# 1,100
LOGIT_ROWS = 3072


@dataclasses.dataclass
class Record:
    """One request as the client saw it: ``due`` (the time it was due to
    be sent), ``sent`` (when it was submitted), its token ``stamps``, and
    when it ``finished`` (None while running)."""

    spec: Spec
    req: object
    due: float
    sent: float
    stamps: List[float] = dataclasses.field(default_factory=list)
    finished: Optional[float] = None
    admitted: Optional[float] = None
    seen_prefill: int = 0
    # (position, row of ``Client.logits``) of the logits kept at a
    # position of prompt + output, each predicting the token after it
    logit_rows: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class StepRecord:
    t0: float
    t1: float
    chunk: bool
    decode: bool
    chunk_s: float = 0.0
    decode_s: float = 0.0
    prefill_rows: int = 0
    # (position of the first prompt token computed, how many) per lane
    prefill_spans: List = dataclasses.field(default_factory=list)
    # position of the token each decoding lane fed
    decode_positions: List[int] = dataclasses.field(default_factory=list)
    # (layer, expert) pairs the decode part computed rows for, summed over
    # its layers (the moe family's; None for a family without experts)
    experts_touched: Optional[int] = None


class Client:
    def __init__(self, engine, traffic: Traffic,
                 clock: Callable[[], float] = time.perf_counter):
        self.eng = engine
        self.traffic = traffic
        self.clock = clock
        self.records: List[Record] = []
        self.steps: List[StepRecord] = []
        self.live: List[Record] = []
        self._next = [0] * len(traffic.streams)
        self._arrival = 0
        self.t_open: Optional[float] = None   # the window's start
        # the requests running when the window opened and those sent in it
        self.attempted: List[Record] = []
        # the most requests outstanding at once from the window's start
        self.most_live = 0
        self.logits = np.empty((LOGIT_ROWS, engine.cfg.vocab_size),
                               np.float32)
        self.logits.fill(0.0)
        self.n_logits = 0
        self._turn = 0
        prefill = engine._prefill_once

        def prefill_once():
            out = prefill()
            self._keep_prompt_logits()
            return out
        engine._prefill_once = prefill_once

    # ------------------------------------------------------------- logits
    def _keep(self, rec: Record, position: int) -> None:
        if self.n_logits >= len(self.logits):
            return
        row = np.asarray(rec.req.last_logits)
        if row.dtype.kind != "f" or row.size != self.logits.shape[1]:
            return      # no logits a row holds (a faulted lane's)
        self.logits[self.n_logits] = row.reshape(-1)
        rec.logit_rows.append((position, self.n_logits))
        self.n_logits += 1

    def _keep_prompt_logits(self) -> None:
        """After the engine's prefill: the logits of each request whose
        prompt it just finished (none of its output yet)."""
        for r in self.live:
            req = r.req
            if (req.last_logits is not None and not req.output
                    and not r.logit_rows):
                self._keep(r, len(req.prompt) - 1)

    # ---------------------------------------------------------- submitting
    def submit(self, spec: Spec, due: float, extra_tokens: int = 0) -> Record:
        sent = self.clock()
        req = self.eng.submit(spec.prompt, spec.max_new + extra_tokens)
        rec = Record(spec, req, due, sent)
        self.records.append(rec)
        self.live.append(rec)
        if self.t_open is not None:
            self.attempted.append(rec)
        return rec

    def send_next(self, client: int, due: float) -> Optional[Record]:
        """The closed loop: ``client``'s next request, due at ``due``."""
        stream = self.traffic.streams[client]
        if self._next[client] >= len(stream):
            return None
        spec = stream[self._next[client]]
        self._next[client] += 1
        return self.submit(spec, due)

    def send_due(self) -> None:
        """The open loop: every request due by now (due times count from
        ``t_open``)."""
        arrivals = self.traffic.arrivals
        now = self.clock()
        while (self._arrival < len(arrivals)
               and self.t_open + arrivals[self._arrival].due <= now):
            spec = arrivals[self._arrival]
            self._arrival += 1
            self.submit(spec, self.t_open + spec.due)

    # ------------------------------------------------------------- stepping
    def step(self) -> StepRecord:
        if self.traffic.loop != "closed" and self.t_open is not None:
            self.send_due()
        eng = self.eng
        n_chunk, n_dec = len(eng.timings["prefill"]), len(eng.timings["decode"])
        touched = eng.experts_touched["decode"]
        n_touched = len(touched)
        rows0 = eng.prefill_computed
        t0 = self.clock()
        finished = eng.step()
        t1 = self.clock()
        rec = StepRecord(t0, t1, len(eng.timings["prefill"]) > n_chunk,
                         len(eng.timings["decode"]) > n_dec)
        if rec.chunk:
            rec.chunk_s = eng.timings["prefill"][-1]
        if rec.decode:
            rec.decode_s = eng.timings["decode"][-1]
            if len(touched) > n_touched:
                rec.experts_touched = touched[-1]
        rec.prefill_rows = eng.prefill_computed - rows0
        resident = {id(r) for r in eng.slot_req if r is not None}
        fresh = []
        for r in self.live:
            req = r.req
            if r.admitted is None and (id(req) in resident or req.done):
                r.admitted = t1
                r.seen_prefill = req.cached_tokens
            done_pos = min(req.prefill_pos, len(req.prompt))
            if done_pos > r.seen_prefill:
                rec.prefill_spans.append((r.seen_prefill,
                                          done_pos - r.seen_prefill))
                r.seen_prefill = done_pos
            if len(r.stamps) < len(req.output) and not req.done:
                fresh.append(r)
            while len(r.stamps) < len(req.output):
                rec.decode_positions.append(len(req.prompt)
                                            + len(r.stamps))
                r.stamps.append(t1)
        if fresh:
            # the logits this step's decode left, after the token it fed
            r = fresh[self._turn % len(fresh)]
            self._turn += 1
            self._keep(r, len(r.req.prompt) + len(r.req.output) - 1)
        self.steps.append(rec)
        for req in finished:
            self._finish(req, t1)
        if self.t_open is not None:
            self.most_live = max(self.most_live, len(self.live))
        return rec

    def _finish(self, req, t: float) -> None:
        for r in self.live:
            if r.req is req:
                r.finished = t
                self.live.remove(r)
                if self.traffic.loop == "closed" and r.spec.client >= 0:
                    self.send_next(r.spec.client, t)
                return

    # ------------------------------------------------------------- phases
    def warm_up(self, decode_steps: int) -> None:
        """Set-up's traffic: the shared contexts once each, to the end;
        then (closed loop) every client's first request, stepped until
        each of them decodes and ``decode_steps`` decode steps more have
        run, so that both step graphs are captured before the window.  The first
        requests ask for ``decode_steps`` more tokens to make up for the
        ones set-up takes.  An open loop runs its first ``lanes``
        arrivals to the end instead."""
        for spec in self.traffic.warm:
            self.submit(spec, self.clock())
        while self.live:
            self.step()
        if self.traffic.loop == "closed":
            firsts = []
            for c, stream in enumerate(self.traffic.streams):
                self._next[c] = 1
                firsts.append(self.submit(stream[0], self.clock(),
                                          decode_steps))
            # until every first request decodes (a client whose first one
            # already finished has sent its next: the loop is running)
            while not all(r.req.last_logits is not None or r.req.done
                          for r in firsts):
                self.step()
            for _ in range(decode_steps):
                self.step()
        else:
            for spec in self.traffic.arrivals[:self.eng.n_slots]:
                self.submit(spec, self.clock())
            while self.live:
                self.step()
            self.records.clear()
        self.steps.clear()

    def run_window(self, seconds: float) -> Dict[str, float]:
        """Step until ``seconds`` have passed; the window closes at the end
        of the last step.  Returns its bounds on the clock."""
        t0 = self.clock()
        self.t_open = t0
        self.attempted = list(self.live)
        first = len(self.steps)
        while self.clock() < t0 + seconds:
            self.step()
        return {"t0": t0, "t1": self.steps[-1].t1, "first_step": first,
                "last_step": len(self.steps)}
