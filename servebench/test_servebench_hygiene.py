"""Import hygiene by whole top-level module name, and BENCHMARK.json held
to the benchmark's contract: names, units, sources, bounds, the files
every entry needs, the cells each metric lists, and the check's budget."""

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
JAX = {"jax", "jaxlib", "flax", "repro"}


def imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES_PY = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in
                    p.parts)


@pytest.mark.parametrize("path", SOURCES_PY, ids=lambda p: p.name)
def test_no_jax_anywhere(path):
    assert not imports(path) & JAX, path


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    # whole top-level names: repro_torch begins with repro
    assert not imports(path) & (JAX | {"repro_torch"}), path
    assert imports(path) <= {"__future__", "hashlib", "typing", "torch",
                             "servebench"}


def test_import_check_compares_whole_names():
    from servebench.harness import forbidden_modules

    assert "repro_torch" not in forbidden_modules()


def metric_entries():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["servebench"]
    assert SPEC["command"] == ["python3", "servebench/run.py"]
    names = [e["name"] for e in SPEC["configs"] + SPEC["workloads"]
             + metric_entries()]
    assert len(names) == len(set(names))
    for e in metric_entries():
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for e in SPEC["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert {e["name"] for e in SPEC["end_to_end"]} >= {"setup_s"}
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_each_cell_has_its_files_and_metrics(cell):
    from servebench import harness

    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    assert harness.config_of(SPEC, ROOT, cell["config"])["model"]
    assert harness.mix_of(ROOT, cell["traffic"])["loop"]
    assert harness.limits_of(ROOT, cell["name"])["max_gap"] > 0
    e2e = {m["name"] for m in harness.metrics_for(SPEC, cell["name"], False)}
    per = harness.metrics_for(SPEC, cell["name"], True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e
    for m in harness.metrics_for(SPEC, cell["name"], False) + per:
        assert callable(harness.reader(ROOT, m["name"]))


def test_configs_lie_under_paths():
    for conf in SPEC["configs"]:
        assert conf["file"].startswith("servebench/configs/")
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["name"] == conf["name"]
        assert data["reduced"] == conf["reduced"] == []
        assert data["source"] == conf["source"]


def test_per_layer_entries():
    layers = {}
    for e in SPEC["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert e["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        layers.setdefault(e["layer"], []).append(e["name"])
        if e["name"].endswith("_roofline") or "share" in e["name"] \
                or "mfu" in e["name"]:
            assert e["unit"] == "%"
    assert set(layers) == {"serving", "model step", "whole step",
                           "kernels", "device"}
