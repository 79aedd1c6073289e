"""Metrics registry: counters, gauges and bounded-bucket histograms.

Host-side, allocation-light instruments for the serving hot path.  An
instrument is identified by ``(name, sorted(labels))``; looking one up
twice returns the same object, so call sites may either cache the handle
(hot loops) or re-look it up (cold paths — a dict get per call).

Design constraints, in order:

* **Bounded state.**  Histograms hold fixed bucket counts (plus sum /
  count / min / max), never raw samples — a million-request run costs
  the same memory as a ten-request run.  Percentiles are estimated by
  linear interpolation inside the owning bucket (error bounded by the
  bucket width).

* **Cheap observation.**  ``Counter.inc`` / ``Histogram.observe`` are a
  few attribute ops and a ``bisect`` — no locks (the serving loop is
  single-threaded host code, like the scheduler and allocator).

* **Two snapshots.**  :meth:`MetricsRegistry.to_dict` is the structured
  form ``ServeEngine.metrics()`` embeds;
  :meth:`MetricsRegistry.prometheus_text` is the standard exposition
  format (``# TYPE`` headers, ``name{label="v"} value`` lines,
  cumulative ``_bucket{le=...}`` histogram series).

The *disabled* path never reaches this module: when ``repro_torch.obs``
is off, engines carry the no-op ``NULL_TELEMETRY`` and no registry
exists at all (see ``repro_torch.obs.telemetry``).  The instruments,
their names and the snapshot formats are the JAX package's.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Tuple

# serve-path latencies span ~100us (a host-side step phase) to ~10s (a
# long request's end-to-end time); buckets are roughly log-spaced so the
# percentile estimate's bucket-width error stays proportional everywhere
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        self.value += n


class Gauge:
    """A value that goes up and down (pool occupancy, queue depth)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Bounded-bucket histogram with percentile estimation.

    ``bounds`` are the finite upper bucket edges; an implicit ``+Inf``
    bucket catches the tail.  ``counts[i]`` holds observations ``v``
    with ``bounds[i-1] < v <= bounds[i]`` (Prometheus ``le`` semantics).
    """

    __slots__ = ("name", "labels", "bounds", "counts", "sum", "count",
                 "min", "max")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 buckets=DEFAULT_LATENCY_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.name = name
        self.labels = labels
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # + the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the q-th percentile (q in 0..100) by linear
        interpolation inside the owning bucket.

        The rank convention is ``pos = (count - 1) * q / 100`` over the
        sorted samples (``numpy.percentile``'s linear method), so
        the estimate differs from the exact answer by at most the width
        of the bucket the rank lands in (the observed min/max clamp the
        open-ended first and +Inf buckets).
        """
        if not self.count:
            return None
        target = (self.count - 1) * q / 100.0
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c > target:
                lo = self.min if i == 0 else self.bounds[i - 1]
                hi = self.max if i == len(self.bounds) else self.bounds[i]
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (target - cum + 0.5) / c  # mid-rank within bucket
                return lo + min(max(frac, 0.0), 1.0) * (hi - lo)
            cum += c
        return self.max

    def to_dict(self) -> Dict:
        return {
            "count": self.count,
            "sum": round(self.sum, 9),
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "buckets": {str(b): c
                        for b, c in zip(self.bounds, self.counts)},
            "inf": self.counts[-1],
        }


class MetricsRegistry:
    """One namespace of instruments; the engine owns one per telemetry.

    ``counter`` / ``gauge`` / ``histogram`` create-or-return: the first
    call with a ``(name, labels)`` pair creates the instrument, later
    calls return the same object.  A name is bound to one instrument
    kind — re-registering it as another kind raises.
    """

    def __init__(self):
        self._counters: Dict[Tuple, Counter] = {}
        self._gauges: Dict[Tuple, Gauge] = {}
        self._hists: Dict[Tuple, Histogram] = {}
        self._kinds: Dict[str, str] = {}

    def _claim(self, name: str, kind: str) -> None:
        have = self._kinds.setdefault(name, kind)
        if have != kind:
            raise ValueError(
                f"metric {name!r} already registered as a {have}, "
                f"cannot re-register as a {kind}")

    def counter(self, name: str, **labels) -> Counter:
        self._claim(name, "counter")
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter(name, key[1])
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        self._claim(name, "gauge")
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge(name, key[1])
        return g

    def histogram(self, name: str, buckets=DEFAULT_LATENCY_BUCKETS,
                  **labels) -> Histogram:
        self._claim(name, "histogram")
        key = (name, _label_key(labels))
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram(name, key[1], buckets)
        return h

    # ------------------------------------------------------------ snapshots
    def to_dict(self) -> Dict:
        """Structured snapshot (what ``ServeEngine.metrics()`` embeds)."""
        return {
            "counters": {
                name + _fmt_labels(lk): c.value
                for (name, lk), c in sorted(self._counters.items())},
            "gauges": {
                name + _fmt_labels(lk): g.value
                for (name, lk), g in sorted(self._gauges.items())},
            "histograms": {
                name + _fmt_labels(lk): h.to_dict()
                for (name, lk), h in sorted(self._hists.items())},
        }

    def prometheus_text(self) -> str:
        """Prometheus exposition-format snapshot."""
        lines: List[str] = []
        typed = set()

        def header(name, kind):
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for (name, lk), c in sorted(self._counters.items()):
            header(name, "counter")
            lines.append(f"{name}{_fmt_labels(lk)} {c.value}")
        for (name, lk), g in sorted(self._gauges.items()):
            header(name, "gauge")
            lines.append(f"{name}{_fmt_labels(lk)} {g.value}")
        for (name, lk), h in sorted(self._hists.items()):
            header(name, "histogram")
            cum = 0
            for b, c in zip(h.bounds, h.counts):
                cum += c
                le = dict(lk)
                le["le"] = repr(b)
                lines.append(
                    f"{name}_bucket{_fmt_labels(_label_key(le))} {cum}")
            le = dict(lk)
            le["le"] = "+Inf"
            lines.append(
                f"{name}_bucket{_fmt_labels(_label_key(le))} {h.count}")
            lines.append(f"{name}_sum{_fmt_labels(lk)} {h.sum}")
            lines.append(f"{name}_count{_fmt_labels(lk)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")
