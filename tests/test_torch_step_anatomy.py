"""The serving engine's step anatomy (``ServeEngine.timings``) and its
mirror for operators (``repro_torch.obs``).

On the CPU, in paged and slots mode:

* ``"<part>_launch"`` aligns index for index with ``timings["prefill"]``
  / ``["decode"]``: each part's step calls, timed from outside (one of
  them 50 ms longer), lie within its launch seconds, to 10 ms, which lie
  within its seconds; ``"step"`` has one entry a
  ``step()``, empty steps included, each at least its parts' seconds;
  ``"<part>_start"`` / ``"<part>_device"`` stay empty;
* with obs off a ``torch.profiler`` span of engine steps holds no
  ``serve.`` range; with ``annotations=True`` each step's range holds
  its ``.launch`` and ``.wait`` ranges;
* a step's Chrome span, moved by the export's ``clock_anchor`` onto a
  ``torch.profiler`` trace of the same steps, encloses that step's
  ``aten::`` operations to within 0.1 ms at both ends.

On the card (marked ``cuda``; skipped without one): a paged and a slots
engine on graphs, a paged engine run eagerly, and a paged engine on a
``(1, 2)`` mesh of two rank processes (``gloo``) whose steps are graph
segments: every part has ``_device`` > 0, ``_start`` >= 0, and
``_start + _device`` within the part's host seconds plus 0.2 ms.  This
file imports no JAX; on the card::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_step_anatomy.py
"""

import dataclasses
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.config import EngineConfig, ServeConfig, get_reduced
from repro_torch.models import init_params
from repro_torch.obs import Telemetry
from repro_torch.obs.trace import ENGINE_TID
from repro_torch.serve import ServeEngine

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15], [16]]
PARTS = ("prefill", "decode")
# the part's host seconds may exceed its device readings' sum by the
# events' resolution and the record call at its start: 0.2 ms
SLACK_S = 2e-4


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_reduced("qwen2.5-3b"), dtype="float32",
                              n_layers=2)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


def make_engine(model, mode, telemetry=None):
    cfg, params = model
    return ServeEngine(cfg, params, ServeConfig(max_new_tokens=4,
                                                page_size=4,
                                                prefill_chunk=3),
                       n_slots=2, max_len=32, mode=mode,
                       telemetry=telemetry, device="cpu")


def step_fns(eng):
    return (("_prefill_paged", "_decode_paged") if eng.mode == "paged"
            else ("_slots_step",))


# -------------------------------------------------------------- timings
@pytest.mark.parametrize("mode", ["paged", "slots"])
def test_lists_align_and_steps_hold_their_parts(model, mode):
    eng = make_engine(model, mode)
    t = eng.timings
    # every step call timed from outside, a delay planted in the fifth
    calls = []
    for name in step_fns(eng):
        def timed(fn=getattr(eng, name)):
            t0 = time.perf_counter()
            if len(calls) == 4:
                time.sleep(0.05)
            out = fn()
            calls.append(time.perf_counter() - t0)
            return out
        setattr(eng, name, timed)
    for p in PROMPTS:
        eng.submit(p)
    steps, prompts = 0, iter(PROMPTS)
    while eng.has_work():
        before = {p: len(t[p]) for p in PARTS}
        first_call = len(calls)
        eng.step()
        steps += 1
        parts = sum(sum(t[p][before[p]:]) for p in PARTS)
        assert t["step"][-1] >= parts
        # the step's calls, part by part: a prefill (in slots mode a
        # prompt's, one call a token) then a decode step
        mine = calls[first_call:]
        for part in PARTS:
            for i in range(before[part], len(t[part])):
                n = (len(next(prompts))
                     if part == "prefill" and mode == "slots" else 1)
                outside, mine = sum(mine[:n]), mine[n:]
                launch = t[part + "_launch"][i]
                assert outside <= launch <= t[part][i]
                assert launch - outside < 0.01
        assert not mine
    assert len(calls) > 5 and max(calls) >= 0.05
    eng.step()      # an empty step counts too
    assert len(t["step"]) == steps + 1
    for part in PARTS:
        assert len(t[part]) == len(t[part + "_launch"]) > 1
        assert t[part + "_start"] == [] == t[part + "_device"]


# ------------------------------------------------------------- profiler
def profiled_steps(eng, n=None):
    """Engine steps under a CPU profiler, each inside a ``test.step.<i>``
    range; returns the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        i = 0
        while eng.has_work() and (n is None or i < n):
            with record_function(f"test.step.{i}"):
                eng.step()
            i += 1
    return prof


def submitted(eng):
    for p in PROMPTS:
        eng.submit(p)
    return eng


@pytest.mark.parametrize("mode", ["paged", "slots"])
def test_no_profiler_range_with_obs_off(model, mode):
    prof = profiled_steps(submitted(make_engine(model, mode)))
    names = {e.name for e in prof.events()}
    assert any(n.startswith("aten::") for n in names)
    assert not [n for n in names if n.startswith("serve.")]


@pytest.mark.parametrize("mode", ["paged", "slots"])
def test_annotations_hold_launch_and_wait(model, mode):
    eng = submitted(make_engine(model, mode, Telemetry(annotations=True)))
    events = profiled_steps(eng).events()
    parts = ("serve.prefill_chunk" if mode == "paged"
             else "serve.prefill_slot", "serve.decode_step")
    seen = {}
    for name in parts:
        outer = [e.time_range for e in events if e.name == name]
        assert outer, name
        for sub in ("launch", "wait"):
            inner = [e.time_range for e in events
                     if e.name == f"{name}.{sub}"]
            assert len(inner) == len(outer), (name, sub)
            for o, r in zip(outer, inner):
                assert o.start <= r.start and r.end <= o.end
            seen[f"{name}.{sub}"] = len(inner)
        launch = [e.time_range for e in events if e.name == f"{name}.launch"]
        wait = [e.time_range for e in events if e.name == f"{name}.wait"]
        assert all(a.end <= b.start for a, b in zip(launch, wait))
    assert {n for n in seen} == {f"{p}.{s}" for p in parts
                                 for s in ("launch", "wait")}


@pytest.mark.parametrize("mode", ["paged", "slots"])
def test_anchor_places_steps_on_the_profiler_trace(model, mode):
    """The Chrome trace's step spans, moved onto the profiler's timebase
    by the export's anchor, enclose each step's ``aten::`` operations
    and lie inside the test's range around the step, to 0.1 ms."""
    tel = Telemetry(trace=True)
    eng = submitted(make_engine(model, mode, tel))
    prof = profiled_steps(eng)
    trace = tel.tracer.export()
    anchor = trace["otherData"]["clock_anchor"]
    base_ns = prof.profiler.kineto_results.trace_start_ns()

    def on_profiler_us(ts):
        # ts: µs since the tracer's start, on perf_counter (the default)
        return (anchor["profiler_unix_ns"] + ts * 1e3 - base_ns) / 1e3

    spans = {}
    for ev in trace["traceEvents"]:
        if ev["tid"] == ENGINE_TID and ev["name"] == "step":
            if ev["ph"] == "B":
                n = ev["args"]["n"]
                spans[n] = [on_profiler_us(ev["ts"]), None]
            elif ev["ph"] == "E":
                spans[n][1] = on_profiler_us(ev["ts"])
    events = prof.events()
    windows = {int(e.name.rsplit(".", 1)[1]): e.time_range for e in events
               if e.name.startswith("test.step.")}
    assert len(spans) == len(windows) > 3
    tol = 100.0     # µs
    checked = 0
    for i, w in windows.items():
        lo, hi = spans[i + 1]
        assert w.start - tol <= lo < hi <= w.end + tol, (i, w, lo, hi)
        ops = [e.time_range for e in events if e.name.startswith("aten::")
               and w.start <= e.time_range.start <= w.end]
        if ops:
            checked += 1
            assert lo <= min(r.start for r in ops) + tol
            assert hi >= max(r.end for r in ops) - tol
    assert checked > 3


def test_no_global_registry():
    import repro_torch.obs as obs

    assert not hasattr(obs, "global_registry")
    assert "global_registry" not in obs.__all__


# ----------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's device readings are "
                    "CUDA events")
    return torch.device("cuda")


def check_device_readings(t):
    """Every part's device readings, against its host seconds."""
    for part in PARTS:
        n = len(t[part])
        assert n > 2, part
        assert (len(t[part + "_launch"]) == len(t[part + "_start"])
                == len(t[part + "_device"]) == n), part
        for host, start, dev in zip(t[part], t[part + "_start"],
                                    t[part + "_device"]):
            assert dev > 0, (part, t)
            assert start >= 0, (part, t)
            assert start + dev <= host + SLACK_S, (part, host, start, dev)


def card_engine(device, mode, graphs):
    cfg = get_reduced("qwen2.5-3b")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         engine_bits=4)
    kv_bits = 8 if mode == "paged" else 0
    return ServeEngine(cfg, params, ServeConfig(
        max_new_tokens=6, page_size=4, prefill_chunk=5,
        engine=EngineConfig(weight_bits=4, kv_bits=kv_bits)),
        n_slots=4, max_len=48, mode=mode, cuda_graphs=graphs, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged", "slots"])
def test_card_graph_replays_read_their_device_span(card, mode):
    eng = card_engine(card, mode, True)
    for p in PROMPTS + PROMPTS:
        eng.submit(p)
    eng.run()
    assert eng.cuda_graphs and eng.timings["capture"]
    check_device_readings(eng.timings)


@pytest.mark.cuda
def test_card_eager_parts_read_their_device_span(card):
    eng = card_engine(card, "paged", False)
    for p in PROMPTS + PROMPTS:
        eng.submit(p)
    eng.run()
    assert not eng.cuda_graphs and not eng.timings["capture"]
    check_device_readings(eng.timings)


MESH_RANK = """
import json, os, sys
sys.path.insert(0, {src!r})
import torch
from repro_torch.config import EngineConfig, ServeConfig, get_reduced
from repro_torch.dist import close_rank, init_rank, make_mesh
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine

rank, out = int(sys.argv[1]), sys.argv[2]
init_rank(rank, 2, os.path.join(out, "store"), backend="gloo")
mesh = make_mesh((1, 2), ("data", "model"))
torch.cuda.set_device(mesh.device)
cfg = get_reduced("qwen2.5-3b")
params = init_params(cfg, torch.Generator(device=mesh.device).manual_seed(0),
                     engine_bits=4)
eng = ServeEngine(cfg, params, ServeConfig(
    max_new_tokens=6, page_size=4, prefill_chunk=5,
    engine=EngineConfig(weight_bits=4, kv_bits=8, sharded=True)),
    n_slots=4, max_len=48, mesh=mesh)
for p in {prompts!r}:
    eng.submit(p)
eng.run()
with open(os.path.join(out, f"rank{{rank}}.json"), "w") as f:
    json.dump(dict(timings=eng.timings,
                   segments=[g.segments for g in eng._graphs]), f)
close_rank()
"""


@pytest.mark.cuda
def test_card_mesh_segments_read_their_device_span(card, tmp_path):
    """Two rank processes on the card (``gloo``) at ``(1, 2)``: a step is
    graph segments with the host's collectives between them; its device
    span runs from the first segment's first node to the last
    segment's last."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    prog = tmp_path / "rank.py"
    prog.write_text(textwrap.dedent(MESH_RANK.format(
        src=src, prompts=PROMPTS + PROMPTS)))
    procs = [subprocess.Popen([sys.executable, str(prog), str(r),
                               str(tmp_path)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    for r in range(2):
        rec = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert rec["segments"] and min(rec["segments"]) > 1
        check_device_readings(rec["timings"])
