"""PyTorch port vs JAX: serve-path observability (``repro_torch.obs``),
mirroring ``tests/test_obs.py``.

The registry, span timelines and Chrome-trace cases run on the port's
modules and their snapshots, Prometheus text and trace validation are held
equal to the JAX package's on the same operations.  The engine cases run
the same traffic (``make_engine`` of ``tests/test_torch_prefix_cache.py``:
reduced qwen2.5-3b in float32, JAX ``backend="reference"`` / ``gather``,
the same weights, every engine at ``audit=2``) through both packages with
live telemetry on one manual clock that moves only between steps: the
registries (counters, gauges, histograms), every request's timeline (its
state sequence with timestamps) and the step counts must be equal, in
paged mode (FCFS, prefix cache, a pool that preempts, the budget
scheduler) and in slots mode.  Greedy tokens are the same with telemetry
on and off, and with it off the engine holds ``NULL_TELEMETRY``, which
stays empty, and reads no clock beyond its own (one read a submission,
one a decode step).

``repro_torch.obs.enable`` / ``repro.obs.enable`` are process-wide and
several test files share a worker, so the ``obs_on`` fixture turns both
on and always turns them off again.
"""

import json

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.config.base import EngineConfig as JaxEngineConfig
from repro.config.base import ServeConfig as JaxServeConfig
from repro.models import init_params
from repro.serve import AdmissionRejected as JaxAdmissionRejected
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import ServeFrontend as JaxServeFrontend

import repro_torch.config as tconfig
import repro_torch.obs as tobs
from repro_torch.obs import (
    NULL_TELEMETRY,
    Histogram,
    MetricsRegistry,
    RequestTimeline,
    Telemetry,
    spans,
    validate_trace,
)
from repro_torch.obs.trace import CACHE_TID, ENGINE_TID, MEM_TID, SCHED_TID
from repro_torch.serve import AdmissionRejected, ServeEngine, ServeFrontend
from repro_torch.weights import params_from_numpy

from conftest import reduced_f32
from test_torch_model import jax_params_to_numpy, torch_cfg
from test_torch_prefix_cache import make_engine

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [4], [5, 6, 7, 8], [2, 2]]


class ManualClock:
    def __init__(self):
        self.t = 0.0
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def model():
    cfg = reduced_f32("qwen2.5-3b")
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture
def obs_on():
    """Both packages' process-wide switch on for one test, always off
    after it."""
    tobs.enable(trace=True)
    jobs.enable(trace=True)
    try:
        yield
    finally:
        tobs.disable()
        jobs.disable()


# ------------------------------------------------------------- registry
def _fill(reg):
    reg.counter("reqs_total", reason="shed").inc(2)
    reg.counter("reqs_total").inc(5)
    reg.gauge("pages_free").set(7)
    reg.gauge("pages_free").dec(2)
    h = reg.histogram("lat_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 3.0):
        h.observe(v)
    return reg


def test_counter_gauge_basics():
    reg = MetricsRegistry()
    c = reg.counter("reqs_total")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("reqs_total") is c
    assert reg.counter("reqs_total", reason="shed") is not c
    g = reg.gauge("depth")
    g.set(3)
    g.inc()
    g.dec(2)
    assert g.value == 2
    with pytest.raises(ValueError):
        reg.gauge("reqs_total")


def test_registry_snapshots_equal_jax():
    """The same operations give the JAX package's ``to_dict`` and
    Prometheus text, character for character."""
    port, ref = _fill(MetricsRegistry()), _fill(jobs.MetricsRegistry())
    assert port.to_dict() == ref.to_dict()
    text = port.prometheus_text()
    assert text == ref.prometheus_text()
    assert "# TYPE reqs_total counter" in text
    assert 'reqs_total{reason="shed"} 2' in text
    assert 'lat_s_bucket{le="1.0"} 3' in text
    assert 'lat_s_bucket{le="+Inf"} 4' in text
    assert "lat_s_count 4" in text


def test_histogram_percentile_tracks_exact_within_bucket_width():
    import bisect
    import random

    rng = random.Random(7)
    h, ref = Histogram("lat", ()), jobs.Histogram("lat", ())
    samples = [rng.uniform(0.0002, 2.0) for _ in range(500)]
    for v in samples:
        h.observe(v)
        ref.observe(v)
    for q in (50, 90, 95, 99):
        est, exact = h.percentile(q), float(np.percentile(samples, q))
        i = bisect.bisect_left(h.bounds, exact)
        lo = h.bounds[i - 1] if i > 0 else h.min
        hi = h.bounds[i] if i < len(h.bounds) else h.max
        assert abs(est - exact) <= (hi - lo) + 1e-12, (q, est, exact)
        assert est == ref.percentile(q)
    assert h.to_dict() == ref.to_dict()


def test_histogram_edges_and_snapshot():
    h = Histogram("lat", (), buckets=(0.1, 1.0))
    for v in (0.05, 0.1, 0.5, 2.0):
        h.observe(v)
    assert h.counts == [2, 1, 1]
    d = h.to_dict()
    assert d["count"] == 4 and d["inf"] == 1
    assert d["min"] == 0.05 and d["max"] == 2.0
    empty = Histogram("none", ())
    assert empty.percentile(50) is None
    assert empty.to_dict()["min"] is None


# ---------------------------------------------------------------- spans
def _lifecycle(timeline_cls, sp):
    tl = timeline_cls(0, submit_t=1.0)
    tl.transition(sp.ADMITTED, 3.0)
    tl.transition(sp.PREFILLING, 3.0)
    tl.transition(sp.PREEMPTED, 3.5)
    tl.transition(sp.ADMITTED, 4.0)
    tl.transition(sp.DECODING, 5.0)
    for t in (5.0, 6.0, 8.0):
        tl.token(t)
    tl.transition(sp.RETIRED, 9.0)
    return tl


def test_timeline_lifecycle_and_latency_decomposition():
    from repro.obs import RequestTimeline as JaxTimeline
    from repro.obs import spans as jspans

    tl = _lifecycle(RequestTimeline, spans)
    assert tl.queue_wait == 2.0
    assert tl.ttft == 4.0
    assert tl.tpot == pytest.approx(1.5)
    assert tl.e2e == 8.0
    assert tl.n_preemptions == 1
    assert tl.finished and tl.state == spans.RETIRED
    assert tl.to_dict() == _lifecycle(JaxTimeline, jspans).to_dict()
    assert spans.TERMINAL == jspans.TERMINAL


def test_telemetry_shed_cancel_timeout_paths():
    """The hooks' effects on a live telemetry equal the JAX package's."""
    snaps = []
    for cls in (Telemetry, jobs.Telemetry):
        clk = ManualClock()
        tel = cls(clk, trace=True)
        tel.attach_engine(2, "paged")
        tel.on_shed("queue_full")
        tel.on_shed("deadline")
        tel.on_submit(0, 4, clk())
        tel.on_submit(1, 4, clk())
        clk.advance(1.0)
        tel.on_cancel(0, "user")
        tel.on_cancel(1, "timed_out")
        tel.on_submit(2, 4, clk())
        tel.on_admit(2, 0, 0)
        tel.on_preempt(2, 0)
        tel.on_fault(2, "nan_logits")
        tel.on_retry(2, "nan_logits", 1)
        tel.on_submit(3, 2, clk())
        tel.on_quarantine(3, "step_fault", 0)
        tel.on_chaos("page_grant")
        tel.on_frontend_shed("queue_full")
        tel.on_frontend_timeout()
        tel.on_audit(2, True)
        snaps.append((tel.snapshot(), {rid: tl.to_dict() for rid, tl
                                       in tel.timelines.items()},
                      validate_trace(tel.tracer.export())))
    port, ref = snaps
    assert port == ref
    assert port[0]["request_states"] == {
        spans.CANCELLED: 1, spans.TIMED_OUT: 1, spans.QUEUED: 1,
        spans.ERRORED: 1}


def test_trace_validation_rejects_malformed(tmp_path):
    clk = ManualClock()
    tel = Telemetry(clk, trace=True)
    tel.attach_engine(1, "paged")
    t0 = clk()
    tel.step_begin()
    clk.advance(0.001)
    tel.step_end(t0)
    path = str(tmp_path / "trace.json")
    tel.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    assert validate_trace(trace) == jobs.validate_trace(trace)

    bad = {"traceEvents": [dict(e) for e in trace["traceEvents"]]}
    del bad["traceEvents"][-1]
    with pytest.raises(ValueError, match="open"):
        validate_trace(bad)
    with pytest.raises(ValueError, match="name"):
        validate_trace({"traceEvents": [{"ph": "B", "ts": 0, "pid": 1,
                                         "tid": 0}]})
    with pytest.raises(ValueError, match="backwards"):
        validate_trace({"traceEvents": [
            {"ph": "B", "ts": 5.0, "pid": 1, "tid": 0, "name": "a"},
            {"ph": "E", "ts": 1.0, "pid": 1, "tid": 0, "name": "a"}]})


# ------------------------------------------------------- disabled path
def test_disabled_telemetry_is_noop(model):
    assert tobs.enabled is False
    assert tobs.telemetry() is NULL_TELEMETRY
    eng = make_engine(model, "torch", page_size=4, prefill_chunk=3,
                      n_slots=2)
    assert eng.obs is NULL_TELEMETRY
    eng.submit([1, 2, 3])
    eng.run()
    assert NULL_TELEMETRY.registry is None
    assert NULL_TELEMETRY.tracer is None
    assert not NULL_TELEMETRY.timelines
    assert NULL_TELEMETRY.snapshot() == {}
    assert NULL_TELEMETRY.export_chrome_trace("/dev/null") is None
    m = eng.metrics()
    assert "obs" not in m and "costs" not in m and m["submitted"] == 1
    # no cost table was built
    assert eng._decode_cost_table is None and eng._cost_specs is None


@pytest.mark.parametrize("mode", ["paged", "slots"])
def test_disabled_telemetry_reads_no_extra_clock(model, mode):
    """With obs off the engine reads its clock once a submission and once
    a decode step (``submit_t``, the tokens' time), as before telemetry;
    with obs on, the same clock is read more."""
    reads = {}
    for on in (False, True):
        clk = ManualClock()
        tel = Telemetry(clk, trace=True) if on else None
        if mode == "paged":
            eng = make_engine(model, "torch", page_size=4, prefill_chunk=3,
                              n_slots=2, clock=clk, telemetry=tel)
        else:
            _, _, tcfg, tparams = model
            eng = ServeEngine(
                tcfg, tparams, tconfig.ServeConfig(max_new_tokens=5),
                n_slots=2, max_len=32, mode="slots", clock=clk,
                telemetry=tel, device="cpu")
        for p in PROMPTS:
            eng.submit(p)
        eng.run()
        reads[on] = (clk.reads, len(PROMPTS) + len(eng.timings["decode"]))
    assert reads[False][0] == reads[False][1]
    assert reads[True][0] > reads[True][1]


def test_tokens_identical_with_telemetry_on_and_off(model):
    def serve(pkg, tel):
        eng = make_engine(model, pkg, page_size=4, prefill_chunk=3,
                          n_slots=2, telemetry=tel, prefix_cache=True)
        reqs = [eng.submit(list(p)) for p in PROMPTS + [[1, 2, 3, 4, 9]]]
        eng.run()
        return [r.output for r in reqs]

    off = serve("torch", None)
    assert serve("torch", Telemetry(trace=True)) == off
    assert serve("jax", None) == off


# ------------------------------------------------------- engine wiring
SCENARIOS = {
    "fcfs": dict(n_slots=2),
    "prefix_cache": dict(n_slots=2, prefix_cache=True),
    "preempt": dict(n_slots=3, n_pages=9, max_new=8),
    "budget": dict(n_slots=2, sched="budget", step_tokens=4,
                   prefix_cache=True),
}
SCENARIO_PROMPTS = [list(range(1, 9)) + [9], [4], list(range(1, 9)) + [20],
                    [5, 6, 7, 8, 9, 10, 11], [2, 2],
                    list(range(1, 9)) + [21, 22]]


def _drive(eng, clk):
    """Submit two prompts, step until the first has a token, submit the
    rest, run dry; the clock moves 1 ms between steps only."""
    reqs = [eng.submit(p) for p in SCENARIO_PROMPTS[:2]]
    steps = 0
    while not reqs[0].output:
        eng.step()
        clk.advance(0.001)
        steps += 1
    reqs += [eng.submit(p) for p in SCENARIO_PROMPTS[2:]]
    while eng.has_work():
        eng.step()
        clk.advance(0.001)
        steps += 1
    return reqs, steps


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_telemetry_equals_jax(model, scenario):
    """Counters, gauges, histograms, the cost ledger and each request's
    timeline (states and times) equal the JAX engine's on the same
    traffic and clock."""
    kw = dict(SCENARIOS[scenario])
    out = {}
    for pkg in ("jax", "torch"):
        clk = ManualClock()
        tel = (jobs.Telemetry if pkg == "jax" else Telemetry)(
            clk, trace=True)
        eng = make_engine(model, pkg, page_size=4, prefill_chunk=3,
                          clock=clk, telemetry=tel, **kw)
        reqs, steps = _drive(eng, clk)
        m = eng.metrics()
        out[pkg] = dict(
            tokens=[r.output for r in reqs], steps=steps,
            snapshot=tel.snapshot(), ft=m["ft"], prefix=m.get("prefix"),
            preemptions=m["preemptions"],
            timelines={rid: tl.to_dict()
                       for rid, tl in tel.timelines.items()},
            tracks=validate_trace(tel.tracer.export()))
    port, ref = out["torch"], out["jax"]
    assert port["tokens"] == ref["tokens"]
    for key in ("steps", "ft", "prefix", "preemptions", "timelines",
                "tracks"):
        assert port[key] == ref[key], key
    assert port["snapshot"]["metrics"] == ref["snapshot"]["metrics"]
    assert port["snapshot"] == ref["snapshot"]
    states = port["snapshot"]["request_states"]
    assert states == {spans.RETIRED: len(SCENARIO_PROMPTS)}
    if scenario == "preempt":
        assert port["preemptions"] > 0
    if kw.get("prefix_cache"):
        assert port["snapshot"]["metrics"]["counters"][
            "prefix_cache_hits_total"] > 0


def test_engine_trace_tracks_end_to_end(model, obs_on):
    """Through the process-wide switch: every track carries events, the
    trace validates, and per-request timelines decompose latency."""
    eng = make_engine(model, "torch", page_size=4, prefill_chunk=3,
                      n_slots=2, prefix_cache=True, max_new=3)
    tel = eng.obs
    assert isinstance(tel, Telemetry)
    prefix = list(range(1, 9))
    r0 = eng.submit(prefix + [9])
    eng.run()
    reqs = [eng.submit(prefix + [20 + i]) for i in range(2)]
    eng.run()
    reg = tel.registry
    assert reg.counter("serve_requests_submitted_total").value == 3
    assert reg.counter("serve_tokens_generated_total").value == sum(
        len(r.output) for r in [r0] + reqs)
    snap = eng.metrics()
    assert snap["obs"]["steps"] > 0
    assert snap["obs"]["request_states"] == {spans.RETIRED: 3}
    counts = validate_trace(tel.tracer.export())
    pid = tel.tracer.pid
    for tid in (ENGINE_TID, 1, SCHED_TID, CACHE_TID, MEM_TID):
        assert counts.get(f"{pid}/{tid}", 0) > 0, f"track {tid} empty"
    names = {(e["tid"], e["name"]) for e in tel.tracer.events}
    assert (1, "prefill") in names and (1, "decode") in names
    assert {(ENGINE_TID, p) for p in ("admit", "prefill", "decode")} <= names
    tl = tel.timelines[reqs[0].rid].to_dict()
    assert tl["ttft_s"] is not None and tl["e2e_s"] >= tl["ttft_s"]
    assert tl["cached_tokens"] == 8
    assert tobs.Telemetry is Telemetry and tel.prometheus_text()


def test_annotations_open_profiler_ranges(model):
    """``annotations=True`` wraps each prefill chunk and decode step in a
    ``record_function`` range that a ``torch.profiler`` session sees."""
    from torch.profiler import ProfilerActivity, profile

    eng = make_engine(model, "torch", page_size=4, prefill_chunk=3,
                      n_slots=2, telemetry=Telemetry(annotations=True))
    eng.submit([1, 2, 3, 4])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run()
    names = {e.name for e in prof.events()}
    assert {"serve.prefill_chunk", "serve.decode_step"} <= names


def test_slots_mode_telemetry_equals_jax(model):
    cfg, params, tcfg, tparams = model
    out = {}
    for pkg in ("jax", "torch"):
        clk = ManualClock()
        if pkg == "jax":
            tel = jobs.Telemetry(clk, trace=True)
            eng = JaxServeEngine(
                cfg, params, JaxServeConfig(
                    max_new_tokens=4,
                    engine=JaxEngineConfig(backend="reference")),
                n_slots=2, max_len=32, mode="slots", clock=clk,
                telemetry=tel)
        else:
            tel = Telemetry(clk, trace=True)
            eng = ServeEngine(tcfg, tparams,
                              tconfig.ServeConfig(max_new_tokens=4),
                              n_slots=2, max_len=32, mode="slots",
                              clock=clk, telemetry=tel, device="cpu")
        reqs = [eng.submit(p) for p in PROMPTS]
        while eng.has_work():
            eng.step()
            clk.advance(0.001)
        out[pkg] = ([r.output for r in reqs], tel.snapshot(),
                    {rid: tl.to_dict() for rid, tl in tel.timelines.items()},
                    validate_trace(tel.tracer.export()), eng.metrics())
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1:4] == out["jax"][1:4]
    m_port, m_ref = out["torch"][4], out["jax"][4]
    assert {k: m_port[k] for k in m_ref} == m_ref


def test_shed_and_frontend_counters_equal_jax(model):
    """Sheds at the engine and at the front end, and a front-end timeout,
    are counted by reason as in JAX."""
    regs = {}
    for pkg in ("jax", "torch"):
        clk = ManualClock()
        tel = (jobs.Telemetry if pkg == "jax" else Telemetry)(
            clk, trace=False)
        eng = make_engine(model, pkg, page_size=4, prefill_chunk=3,
                          n_slots=1, sched="budget", max_queue=1,
                          clock=clk, telemetry=tel)
        eng.submit([1, 2, 3])
        rejected = JaxAdmissionRejected if pkg == "jax" else (
            AdmissionRejected)
        with pytest.raises(rejected):
            eng.submit([4, 5, 6])
        eng.run()
        fe = (JaxServeFrontend if pkg == "jax" else ServeFrontend)(
            eng, clock=clk)
        live = fe.submit([7, 8, 9], deadline_s=0.0025)
        shed = fe.submit([1, 1])
        assert shed.state == "shed"
        while fe.step():
            clk.advance(0.001)
        assert live.state == "timed_out"
        regs[pkg] = (tel.registry.to_dict(), fe.shed_count,
                     fe.timeout_count)
    assert regs["torch"] == regs["jax"]
    counters = regs["torch"][0]["counters"]
    assert counters['serve_requests_shed_total{reason="queue_full"}'] == 2
    assert counters['frontend_shed_total{reason="queue_full"}'] == 1
    assert counters["frontend_timeouts_total"] == 1


def test_ttft_is_per_request_not_run_relative(model):
    clk = ManualClock()
    tel = Telemetry(clk, trace=False)
    eng = make_engine(model, "torch", page_size=4, prefill_chunk=3,
                      n_slots=2, telemetry=tel, clock=clk)
    r1 = eng.submit([1, 2, 3])
    while not r1.output:
        clk.advance(0.01)
        eng.step()
    gap = 10.0
    clk.advance(gap)
    r2 = eng.submit([4, 5, 6])
    while r2.ttft is None:
        clk.advance(0.01)
        eng.step()
    eng.run()
    assert r2.ttft < gap / 2, r2.ttft
    assert r1.ttft is not None and r1.ttft < gap / 2
    assert tel.timelines[r2.rid].ttft == pytest.approx(r2.ttft)
    assert tel.registry.histogram("serve_ttft_s").count == 2
