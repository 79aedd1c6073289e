"""The step-anatomy readers (``graph_idle_share``, ``graph_start_ms``,
``step_host_ms``) on synthetic engine lists and client steps: the window
is cut from the engine's lists by position, the steps after it (the wait
for a prefilling lane, the traced span) left out; the part seconds picked
must equal those the client kept; a run without device readings gives
nothing; each value is worked out by hand."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from servebench import harness
from servebench.client import StepRecord
from servebench.window import Run

ROOT = Path(__file__).resolve().parents[1]
MODEL = json.loads((ROOT / "servebench" / "configs"
                    / "starcoder2-15b.json").read_text())
SERVE = {"lanes": 8, "prefill_chunk": 32, "max_len": 4096}
NAMES = ("graph_idle_share", "graph_start_ms", "step_host_ms")

# (chunk seconds or None, decode seconds or None, step seconds) a step,
# with each part's (start, device) seconds on the card
WARM = [((4.0, (1.0, 3.0)), None, 5.0), (None, (5.5, (0.5, 5.0)), 6.0)]
WINDOW = [((0.2, (0.002, 0.15)), (0.05, (0.001, 0.04)), 0.27),
          (None, (0.06, (0.003, 0.045)), 0.065),
          (None, None, 0.001)]
AFTER = [((0.3, (0.009, 0.25)), None, 0.31),
         (None, (0.07, (0.008, 0.06)), 0.075)]


def read(name, run):
    return harness.reader(ROOT, name)(run)


def make_run(warm=WARM, window=WINDOW, after=AFTER, device=True,
             keep=None):
    """The engine's lists over every step; the client's records of the
    window and the steps after it (set-up's were cleared); ``keep`` maps
    a window step's index to chunk seconds the client kept instead."""
    timings = {k: [] for k in (
        "step", "prefill", "prefill_launch", "prefill_start",
        "prefill_device", "decode", "decode_launch", "decode_start",
        "decode_device")}
    records = []
    for i, (chunk, dec, step_s) in enumerate(warm + window + after):
        timings["step"].append(step_s)
        for part, got in (("prefill", chunk), ("decode", dec)):
            if got is None:
                continue
            seconds, (start, dev) = got
            timings[part].append(seconds)
            timings[part + "_launch"].append(seconds / 10)
            if device:
                timings[part + "_start"].append(start)
                timings[part + "_device"].append(dev)
        if i >= len(warm):
            rec = StepRecord(0.0, 0.0, chunk is not None, dec is not None)
            rec.chunk_s = chunk[0] if chunk else 0.0
            rec.decode_s = dec[0] if dec else 0.0
            records.append(rec)
    for i, s in (keep or {}).items():
        records[i].chunk_s = s
    client = SimpleNamespace(records=[], steps=records,
                             eng=SimpleNamespace(timings=timings,
                                                 prefix_cache=None))
    return Run(client, {"t0": 0.0, "t1": 1.0, "first_step": 0,
                        "last_step": len(window)},
               MODEL["model"], MODEL["engine"], SERVE, 12.5, 0)


def test_values_by_hand():
    run = make_run()
    # the window's device seconds: 0.15 + 0.04 + 0.045 of 1 s
    assert read("graph_idle_share", run) == pytest.approx(76.5)
    # starts of the window's three parts: 2, 1 and 3 ms
    assert read("graph_start_ms", run) == pytest.approx(2.0)
    # outside the parts: 0.27 - 0.25, 0.065 - 0.06 and the empty 0.001
    assert read("step_host_ms", run) == pytest.approx(26.0 / 3)


def test_steps_after_the_window_are_left_out():
    base = [read(n, make_run()) for n in NAMES]
    longer = AFTER + [((9.0, (0.5, 8.0)), (9.0, (0.5, 8.0)), 20.0)] * 3
    assert [read(n, make_run(after=longer)) for n in NAMES] == base
    # no steps after it: the window is the newest entries
    assert [read(n, make_run(after=[])) for n in NAMES] == base
    # more set-up before it changes nothing either
    assert [read(n, make_run(warm=WARM * 3)) for n in NAMES] == base


def test_the_window_is_cut_by_position():
    """A window of its last step alone, the empty one: nothing ran on the
    card, and the step is all host time."""
    run = make_run()
    run.steps = run.steps[2:3]
    assert read("graph_idle_share", run) == pytest.approx(100.0)
    assert read("graph_start_ms", run) is None
    assert read("step_host_ms", run) == pytest.approx(1.0)
    # the window's first step alone: its chunk and its decode step
    run = make_run()
    run.steps = run.client.steps[:1]
    assert read("graph_idle_share", run) == pytest.approx(81.0)
    assert read("graph_start_ms", run) == pytest.approx(1.5)
    assert read("step_host_ms", run) == pytest.approx(20.0)


def test_picked_seconds_must_equal_the_clients():
    assert all(read(n, make_run(keep={0: 0.2})) is not None for n in NAMES)
    assert all(read(n, make_run(keep={0: 0.3})) is None for n in NAMES)


def test_nothing_without_device_readings():
    """On the CPU the engine keeps no device lists; the parent program
    keeps no step anatomy at all: the readers give None and raise
    nothing."""
    assert all(read(n, make_run(device=False)) is None for n in NAMES)
    run = make_run()
    run.client.eng.timings = {"prefill": list(run.client.eng.timings[
        "prefill"]), "decode": list(run.client.eng.timings["decode"])}
    assert all(read(n, run) is None for n in NAMES)


def test_entries_in_benchmark_json():
    spec = harness.load_spec(ROOT)
    cells = [w["name"] for w in spec["workloads"]]
    per = {m["name"]: m for m in spec["per_layer"]}
    for name, unit, layer in (("graph_idle_share", "%", "device"),
                              ("graph_start_ms", "ms", "model step"),
                              ("step_host_ms", "ms", "serving")):
        m = per[name]
        assert (m["unit"], m["layer"], m["source"], m["moves"],
                m["better"]) == (unit, layer, "program_span",
                                 "output_tok_s", "lower")
        assert m["workloads"] == cells
