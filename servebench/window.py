"""What the metric readers read: one run's measured window.

``Run`` holds the client's records, the window's bounds on the host
clock, the configuration's sizes and serving settings, set-up's seconds,
the peak of device memory, in a ``--trace 1`` run the traced span's
summary (``profile.py``), and the configuration's family module, whose
``token_flops`` and ``decode_step_bytes`` price the steps.  Its helpers
cut the records to the window: every number a reader gives is taken over
all the window's work and all its time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by the nearest rank: the smallest
    value with at least ``q`` percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


class Run:
    def __init__(self, client, window: Dict, model: Dict, engine: Dict,
                 serve: Dict, setup_s: float, memory_peak_bytes: int,
                 profile: Optional[Dict] = None, family=None):
        self.client = client
        self.t0, self.t1 = window["t0"], window["t1"]
        self.steps = client.steps[window["first_step"]:window["last_step"]]
        self.model, self.engine, self.serve = model, engine, serve
        self.setup_s = setup_s
        self.memory_peak_bytes = memory_peak_bytes
        self.profile = profile or {}
        self.family = family

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def _inside(self, t: float) -> bool:
        return self.t0 < t <= self.t1

    def stamps(self) -> List[float]:
        """Every output token that arrived in the window."""
        return [t for r in self.client.records for t in r.stamps
                if self._inside(t)]

    def gaps(self) -> List[float]:
        """Every inter-token gap in the window: the time from one token of
        a request to its next, both arrived in the window."""
        out = []
        for r in self.client.records:
            s = [t for t in r.stamps if self._inside(t)]
            out.extend(b - a for a, b in zip(s, s[1:]))
        return out

    def ttfts(self) -> List[float]:
        """Time to first token of every request due in the window, from
        its due time; ``inf`` where it failed or had no first token by the
        window's end."""
        out = []
        for r in self.client.records:
            if not self._inside(r.due):
                continue
            failed = getattr(r.req, "finish_reason", None) not in (None,
                                                                   "length")
            if failed or not r.stamps or r.stamps[0] > self.t1:
                out.append(math.inf)
            else:
                out.append(r.stamps[0] - r.due)
        return out
