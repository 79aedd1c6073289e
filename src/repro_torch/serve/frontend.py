"""Streaming front end over :class:`~repro_torch.serve.engine.ServeEngine`.

The engine is a batch loop: ``submit`` everything, ``run()`` to
completion, read ``req.output``.  Production serving is the opposite
shape — requests arrive continuously, every one wants its tokens *as
they are produced*, some carry deadlines, and under overload the system
must shed load instead of letting every request's latency grow without
bound.  This module is that layer:

* :meth:`ServeFrontend.submit` returns a :class:`TokenStream`
  immediately — an iterator that yields token ids as the engine emits
  them.  Iterating a stream drives the *shared* engine (every pending
  request advances together, exactly like the batch loop), so the
  streamed token sequence is identical to what ``run()`` would have
  produced for the same seeds: streaming changes *when* you see tokens,
  never *which* tokens.

* **Deadlines** (``deadline_s``, relative to arrival) and
  :meth:`TokenStream.cancel` both route through ``ServeEngine.cancel``:
  the request's pages and prefix-cache pins are released the moment the
  deadline trips or the caller hangs up — mid-prefill included — and any
  tokens already generated remain on the stream.

* **Load shedding**: when the engine refuses admission
  (:class:`~repro_torch.serve.engine.AdmissionRejected` — bounded queue full,
  or a prompt that can never fit the pool), ``submit`` still returns a
  stream, born terminal in state ``shed`` with the refusal reason.  The
  caller sees one uniform surface; nothing raises on the hot path.

Stream lifecycle::

    queued -> prefilling -> decoding -> done
       |           |           |     -> cancelled  (TokenStream.cancel)
       |           +-----------+---- -> timed_out  (deadline_s elapsed)
       |           +-----------+---- -> error      (quarantined by the
       |                                            engine's fault path)
       +---------------------------- -> shed       (admission refused)

The front-end is synchronous-cooperative, not threaded: ``step()`` runs
one engine step and pumps finished tokens into every live stream, and
stream iteration calls ``step()`` on demand.  A ``clock`` injectable
(default the serve-path clock, :func:`repro_torch.obs.clock.now`) keeps
deadline behavior deterministic under test.  Like the scheduler and
allocator, all of this is host-side state: nothing here changes what the
serving steps (or their CUDA graphs) see.  Sheds and timeouts report to
the engine's telemetry, and the engine's ``ChaosInjector`` fires the
front end's two sites in ``step``: ``cancel`` (a client hangs up) and
``deadline_skew`` (the deadline sweep sees a clock ``skew_s`` ahead).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from repro_torch.obs import clock as _obs_clock
from repro_torch.serve.engine import AdmissionRejected, Request, ServeEngine

# terminal stream states
DONE = "done"
CANCELLED = "cancelled"
TIMED_OUT = "timed_out"
SHED = "shed"
# quarantined by the engine after a step fault / non-finite logits
# exhausted its retry budget (finish_reason="error")
ERROR = "error"
# live stream states (mirror ServeEngine.request_phase)
QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"

TERMINAL_STATES = (DONE, CANCELLED, TIMED_OUT, SHED, ERROR)


class TokenStream:
    """One request's async handle: iterate for tokens, inspect for SLA.

    ``tokens`` / ``token_times`` grow as the engine emits; ``state`` is
    one of queued/prefilling/decoding/done/cancelled/timed_out/shed/error.
    ``first_token_t`` / ``finish_t`` are clock readings for TTFT/TPOT
    accounting (``None`` until they happen).  Iteration yields each
    token id exactly once, driving the shared engine while this stream
    is live and ending (``StopIteration``) once the stream is terminal
    and drained — a shed stream simply yields nothing.
    """

    def __init__(self, frontend: "ServeFrontend", req: Optional[Request],
                 arrival_t: float, deadline_s: Optional[float] = None,
                 shed_reason: Optional[str] = None):
        self._fe = frontend
        self.req = req  # None iff shed at the door
        self.arrival_t = arrival_t
        self.deadline_s = deadline_s
        self.shed_reason = shed_reason
        self.tokens: List[int] = []
        self.token_times: List[float] = []
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = arrival_t if shed_reason else None
        self.state = SHED if shed_reason else QUEUED
        self._cursor = 0

    # ------------------------------------------------------------- views
    @property
    def rid(self) -> Optional[int]:
        return self.req.rid if self.req is not None else None

    @property
    def finished(self) -> bool:
        return self.state in TERMINAL_STATES

    def ttft(self) -> Optional[float]:
        """Arrival -> first token (None until the first token lands)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    def tpot(self) -> Optional[float]:
        """Mean inter-token time after the first (None under 2 tokens)."""
        if len(self.tokens) < 2:
            return None
        span = self.token_times[-1] - self.token_times[0]
        return span / (len(self.tokens) - 1)

    # ---------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[int]:
        return self

    def __next__(self) -> int:
        while self._cursor >= len(self.tokens):
            if self.finished:
                raise StopIteration
            self._fe.step()
        tok = self.tokens[self._cursor]
        self._cursor += 1
        return tok

    def result(self) -> List[int]:
        """Block (drive the engine) until terminal; returns all tokens."""
        for _ in self:
            pass
        return self.tokens

    def cancel(self) -> bool:
        """Hang up: release the request's pages and prefix-cache pins
        immediately.  Tokens already streamed stay valid."""
        return self._fe.cancel(self)


class ServeFrontend:
    """Streaming request surface over one shared :class:`ServeEngine`.

    ``clock``: injectable monotonic time source (seconds) — deadlines
    and token timestamps read it, so tests drive it manually.
    """

    def __init__(self, engine: ServeEngine, clock=None):
        self.engine = engine
        self._clock = clock if clock is not None else _obs_clock.now
        self.streams: List[TokenStream] = []   # every submission, in order
        self._live: List[TokenStream] = []
        self.shed_count = 0
        self.timeout_count = 0

    # ---------------------------------------------------------- lifecycle
    def submit(self, prompt: List[int],
               max_new_tokens: Optional[int] = None, *,
               priority: str = "default", tenant: str = "default",
               deadline_s: Optional[float] = None) -> TokenStream:
        """Enqueue a prompt; returns its stream immediately.

        ``deadline_s``: seconds after arrival by which the request must
        *finish*; past it the request is cancelled (state ``timed_out``)
        and its resources released.  Admission refusals come back as a
        terminal ``shed`` stream, not an exception; malformed prompts
        (empty / over ``max_len``) still raise ``ValueError``.
        """
        now = self._clock()
        try:
            req = self.engine.submit(prompt, max_new_tokens,
                                     priority=priority, tenant=tenant)
        except AdmissionRejected as e:
            self.shed_count += 1
            self.engine.obs.on_frontend_shed(e.reason)
            stream = TokenStream(self, None, now, deadline_s,
                                 shed_reason=e.reason)
            self.streams.append(stream)
            return stream
        stream = TokenStream(self, req, now, deadline_s)
        self.streams.append(stream)
        self._live.append(stream)
        return stream

    def cancel(self, stream: TokenStream, reason: str = "cancelled") -> bool:
        """Cancel a live stream (pages + cache pins released now)."""
        if stream.finished or stream.req is None:
            return False
        self.engine.cancel(stream.req, reason)
        self._pump()
        return True

    # ------------------------------------------------------------ driving
    def has_live(self) -> bool:
        """True while any stream is not yet terminal."""
        return bool(self._live)

    def step(self) -> bool:
        """Expire deadlines, run one engine step, pump new tokens into
        their streams.  Returns True while any live stream remains."""
        now = self._clock()
        chaos = self.engine.chaos
        if chaos is not None and self._live:
            # fire() reports itself through chaos.obs
            if chaos.fire("cancel"):
                victim = self._live[chaos.pick("cancel", len(self._live))]
                self.cancel(victim)
            if chaos.fire("deadline_skew"):
                # the sweep below sees a skewed clock: deadlines near the
                # boundary trip early, mid-prefill or mid-decode
                now = now + chaos.skew_s
        for stream in list(self._live):
            if (stream.deadline_s is not None
                    and now - stream.arrival_t >= stream.deadline_s):
                # cancel() is False if the engine already retired or
                # quarantined the request: without the guard it would be
                # counted timed out *and* keep its real terminal state
                if self.engine.cancel(stream.req, "timed_out"):
                    self.timeout_count += 1
                    self.engine.obs.on_frontend_timeout()
        if self.engine.has_work():
            self.engine.step()
        self._pump()
        return bool(self._live)

    def drain(self) -> List[TokenStream]:
        """Drive until every stream is terminal; returns all streams."""
        while self.step():
            pass
        return self.streams

    def _pump(self) -> None:
        """Move newly generated tokens and state changes onto streams."""
        now = self._clock()
        still_live = []
        for stream in self._live:
            req = stream.req
            new = req.output[len(stream.tokens):]
            if new:
                if stream.first_token_t is None:
                    stream.first_token_t = now
                stream.tokens.extend(int(t) for t in new)
                stream.token_times.extend([now] * len(new))
            if req.done:
                stream.state = DONE
                stream.finish_t = now
            elif req.cancelled:
                if req.finish_reason == "timed_out":
                    stream.state = TIMED_OUT
                elif req.finish_reason == "error":
                    stream.state = ERROR
                else:
                    stream.state = CANCELLED
                stream.finish_t = now
            else:
                stream.state = self.engine.request_phase(req)
                still_live.append(stream)
        self._live = still_live
