"""Straggler detection and mitigation, the JAX package's
(``repro.ft.straggler``).

On synchronous hardware a straggling host delays every collective; at
1000+ nodes a persistent straggler costs its slowdown fleet-wide.  The
monitor keeps a window of step times (per host when timings are reported
per host) and flags hosts/steps exceeding ``threshold`` x the fleet
median.  Mitigations (configurable):

  * "flag"      — report only (default; feeds the ops pager)
  * "skip"      — drop the straggler's microbatch contribution this step
  * "evict"     — request an elastic shrink (elastic meshes are not ported)

The detector is pure Python over reported timings, so it is fully
testable without hardware.
"""

from __future__ import annotations

import statistics
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List


@dataclass
class StragglerEvent:
    step: int
    host: int
    step_time: float
    median: float
    ratio: float
    action: str


@dataclass
class StragglerMonitor:
    threshold: float = 2.0          # x median
    window: int = 32
    patience: int = 3               # consecutive flags before mitigation
    mitigation: str = "flag"        # flag | skip | evict
    _times: Dict[int, Deque[float]] = field(
        default_factory=lambda: defaultdict(lambda: deque(maxlen=32)))
    _flags: Dict[int, int] = field(default_factory=lambda: defaultdict(int))
    events: List[StragglerEvent] = field(default_factory=list)

    def observe(self, step: int, host_times: Dict[int, float]
                ) -> List[StragglerEvent]:
        """Feed one step's per-host times; returns new events."""
        med = statistics.median(host_times.values())
        new: List[StragglerEvent] = []
        for host, t in host_times.items():
            self._times[host].append(t)
            ratio = t / med if med > 0 else 1.0
            if ratio > self.threshold:
                self._flags[host] += 1
            else:
                self._flags[host] = 0
            if self._flags[host] >= self.patience:
                ev = StragglerEvent(step, host, t, med, ratio,
                                    self.mitigation)
                self.events.append(ev)
                new.append(ev)
                self._flags[host] = 0
        return new

    def chronic_hosts(self) -> List[int]:
        """Hosts whose median time exceeds threshold x fleet median."""
        if not self._times:
            return []
        host_meds = {h: statistics.median(ts) for h, ts in self._times.items()
                     if ts}
        fleet = statistics.median(host_meds.values())
        return [h for h, m in host_meds.items()
                if fleet > 0 and m / fleet > self.threshold]
