"""Serve-path observability: metrics, span timelines, step tracing and
the cost ledger.

The package has one process-wide switch, :data:`enabled`.  Components
that want instrumentation call :func:`telemetry` at construction time:
with the switch off (the default) they get the shared no-op
:data:`~repro_torch.obs.telemetry.NULL_TELEMETRY` and the serve path
reads no clock and allocates no state for it.  With the switch on they
get a live :class:`~repro_torch.obs.telemetry.Telemetry` carrying a
:class:`~repro_torch.obs.registry.MetricsRegistry`, per-request
:class:`~repro_torch.obs.spans.RequestTimeline` records, a
:class:`~repro_torch.obs.costs.CostLedger` and (optionally) a
:class:`~repro_torch.obs.trace.ChromeTracer`.

Typical use::

    import repro_torch.obs as obs

    obs.enable()                     # metrics + timelines + Chrome trace
    eng = ServeEngine(...)           # picks up a live telemetry
    eng.run()
    print(eng.metrics()["obs"])      # structured snapshot
    print(eng.metrics()["costs"])    # modeled FLOPs / bytes by op
    eng.obs.export_chrome_trace("trace.json")   # load in Perfetto
    obs.disable()

``enable(trace=False)`` keeps metrics, timelines and the ledger but
skips trace-event collection; ``enable(annotations=True)`` additionally
wraps each prefill / decode step in a ``torch.profiler.record_function``
range, and inside it its launch (``<step>.launch``) and the wait for its
logits (``<step>.wait``), so host spans line up with a device profile;
with annotations off nothing opens a profiler range.  The surface is the
JAX package's ``repro.obs`` (its ``jax_annotations`` is ``annotations``
here).
"""

from __future__ import annotations

from repro_torch.obs import clock
from repro_torch.obs import costs
from repro_torch.obs.costs import (
    CostLedger,
    LinearSpec,
    ModelDims,
    OpCost,
    decode_step_costs,
    fork_cost,
    gemv_cost,
    linear_specs,
    model_dims,
    prefill_chunk_costs,
    routed_costs,
    specs_from_dims,
    total_cost,
)
from repro_torch.obs.registry import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.spans import RequestTimeline
from repro_torch.obs.telemetry import NULL_TELEMETRY, NullTelemetry, Telemetry
from repro_torch.obs.trace import ChromeTracer, validate_trace

__all__ = [
    "ChromeTracer",
    "CostLedger",
    "Counter",
    "DEFAULT_LATENCY_BUCKETS",
    "Gauge",
    "Histogram",
    "LinearSpec",
    "MetricsRegistry",
    "ModelDims",
    "NULL_TELEMETRY",
    "NullTelemetry",
    "OpCost",
    "RequestTimeline",
    "Telemetry",
    "clock",
    "costs",
    "decode_step_costs",
    "disable",
    "enable",
    "fork_cost",
    "gemv_cost",
    "linear_specs",
    "model_dims",
    "prefill_chunk_costs",
    "routed_costs",
    "specs_from_dims",
    "telemetry",
    "total_cost",
    "validate_trace",
]

# process-wide switch + the options enable() captured
enabled = False
_trace = True
_annotations = False


def enable(trace: bool = True, annotations: bool = False) -> None:
    """Turn instrumentation on for subsequently built components."""
    global enabled, _trace, _annotations
    enabled = True
    _trace = trace
    _annotations = annotations


def disable() -> None:
    """Back to the no-op path for subsequently built components."""
    global enabled
    enabled = False


def telemetry(clock_fn=None):
    """The telemetry for a component built *now*: live iff enabled."""
    if not enabled:
        return NULL_TELEMETRY
    return Telemetry(clock_fn, trace=_trace, annotations=_annotations)
