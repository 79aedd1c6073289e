"""Chrome trace-event export: see where every step's cycles go.

:class:`ChromeTracer` collects structured events from the serving stack
and exports them as Chrome trace-event JSON (the ``traceEvents`` array
format) — load the file in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing`` and the serve path renders as a timeline:

* **engine track** (tid 0): one ``B``/``E`` pair per ``ServeEngine.step``
  with nested ``admit`` / ``prefill`` / ``decode`` phase spans;
* **one track per lane** (tid 1..n_slots): ``X`` (complete) spans for
  each chunked-prefill and decode-step dispatch the lane took part in,
  tagged with the owning request id;
* **scheduler track**: instants for admissions, preemptions and sheds;
* **prefix-cache track**: instants for hits / misses / inserts /
  evictions / COW forks;
* **pages track**: a ``C`` (counter) series of free vs cache-resident
  pages — pool pressure over time.

Timestamps are microseconds on the telemetry clock, relative to tracer
construction, so host spans line up with each other exactly; with
``annotations`` enabled the same dispatch sites also carry
``torch.profiler.record_function`` ranges so the host timeline can be
aligned with a device profile captured by ``torch.profiler``.  The
export's ``otherData["clock_anchor"]`` places the trace on the
profiler's timebase without any range: the tracer's start read at once
on ``time.perf_counter`` (``perf_counter_s``) and in Unix nanoseconds
on the real-time clock (``profiler_unix_ns``), the timebase to which
``torch.profiler`` converts its events.  On the default clock
(``perf_counter``) an event at ``ts`` µs lies at ``profiler_unix_ns +
ts * 1e3``.

The event buffer is bounded (``max_events``): a runaway run drops
events past the cap (counted in ``dropped``) instead of eating the
host's memory — the exported metadata records the truncation.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

# fixed track ids: lanes are 1..n_slots, service tracks sit far above
# any plausible lane count so the ids never collide
ENGINE_TID = 0
SCHED_TID = 1000
CACHE_TID = 1001
PAGES_TID = 1002
MEM_TID = 1003  # "memory" track: pool occupancy/evictable/cached per step

REQUIRED_KEYS = ("ph", "ts", "pid", "tid", "name")


class ChromeTracer:
    """Bounded collector of Chrome trace events on an injectable clock."""

    def __init__(self, clock, pid: int = 1, max_events: int = 500_000):
        self._clock = clock
        # the anchor: the start on the profiler's timebase (Unix ns, the
        # real-time clock its events are converted to) and on perf_counter
        # (the mean of a reading before and one after)
        before = time.perf_counter()
        self._t0_unix_ns = time.time_ns()
        self._t0_perf = (before + time.perf_counter()) / 2
        self._t0 = clock()
        self.pid = pid
        self.max_events = max_events
        self.events: List[Dict] = []
        self.dropped = 0
        self._named_tids = set()

    # ------------------------------------------------------------- plumbing
    def ts(self, t: Optional[float] = None) -> float:
        """Microseconds since tracer start (trace-relative)."""
        return ((self._clock() if t is None else t) - self._t0) * 1e6

    def _push(self, ev: Dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def thread_name(self, tid: int, name: str) -> None:
        """Label a track (idempotent; Perfetto reads these ``M`` events)."""
        if tid in self._named_tids:
            return
        self._named_tids.add(tid)
        self._push({"ph": "M", "ts": 0, "pid": self.pid, "tid": tid,
                    "name": "thread_name", "args": {"name": name}})

    # --------------------------------------------------------------- events
    def begin(self, tid: int, name: str, args: Optional[Dict] = None,
              t: Optional[float] = None) -> None:
        ev = {"ph": "B", "ts": self.ts(t), "pid": self.pid, "tid": tid,
              "name": name}
        if args:
            ev["args"] = args
        self._push(ev)

    def end(self, tid: int, name: str, t: Optional[float] = None) -> None:
        self._push({"ph": "E", "ts": self.ts(t), "pid": self.pid,
                    "tid": tid, "name": name})

    def complete(self, tid: int, name: str, t0: float, t1: float,
                 args: Optional[Dict] = None) -> None:
        """An ``X`` span from clock readings ``t0``..``t1`` (seconds)."""
        ev = {"ph": "X", "ts": self.ts(t0), "dur": max(t1 - t0, 0.0) * 1e6,
              "pid": self.pid, "tid": tid, "name": name}
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, tid: int, name: str,
                args: Optional[Dict] = None) -> None:
        ev = {"ph": "i", "ts": self.ts(), "pid": self.pid, "tid": tid,
              "name": name, "s": "t"}
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, tid: int, name: str, values: Dict) -> None:
        self._push({"ph": "C", "ts": self.ts(), "pid": self.pid,
                    "tid": tid, "name": name, "args": dict(values)})

    # --------------------------------------------------------------- export
    def export(self) -> Dict:
        """The trace as a JSON-serializable dict (Perfetto-loadable)."""
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped,
                          "clock_anchor": {
                              "perf_counter_s": self._t0_perf,
                              "profiler_unix_ns": self._t0_unix_ns}},
        }

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.export(), f)
        return path


def validate_trace(trace: Dict) -> Dict:
    """Validate a Chrome trace-event dict; raises ``ValueError`` on the
    first violation, returns per-track event counts on success.

    Checks the trace-event schema contract the tests and CI gate on:

    * every event carries ``ph``/``ts``/``pid``/``tid``/``name``;
    * ``X`` events carry a non-negative ``dur``;
    * per ``(pid, tid)`` track, ``B``/``E`` pairs nest consistently in
      timestamp order (every ``E`` closes the innermost open ``B`` of
      the same name; nothing is left open at the end);
    * timestamps never run backwards within a track's ``B``/``E`` flow.
    """
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace has no traceEvents list")
    tracks: Dict = {}
    counts: Dict[str, int] = {}
    for i, ev in enumerate(events):
        for k in REQUIRED_KEYS:
            if k not in ev:
                raise ValueError(f"event {i} missing required key {k!r}: "
                                 f"{ev}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i} has bad ts {ev['ts']!r}")
        key = (ev["pid"], ev["tid"])
        counts[f"{key[0]}/{key[1]}"] = counts.get(f"{key[0]}/{key[1]}", 0) + 1
        if ev["ph"] == "X":
            if ev.get("dur", -1) < 0:
                raise ValueError(f"X event {i} has bad dur: {ev}")
            continue
        if ev["ph"] not in ("B", "E"):
            continue
        stack, last_ts = tracks.setdefault(key, ([], [0.0]))
        if ev["ts"] < last_ts[0] - 1e-6:
            raise ValueError(
                f"track {key} B/E ts ran backwards at event {i}: "
                f"{ev['ts']} < {last_ts[0]}")
        last_ts[0] = ev["ts"]
        if ev["ph"] == "B":
            stack.append(ev["name"])
        else:
            if not stack:
                raise ValueError(f"track {key} E without open B: {ev}")
            opened = stack.pop()
            if opened != ev["name"]:
                raise ValueError(
                    f"track {key} E {ev['name']!r} closes B {opened!r}")
    for key, (stack, _) in tracks.items():
        if stack:
            raise ValueError(f"track {key} left spans open: {stack}")
    return counts
