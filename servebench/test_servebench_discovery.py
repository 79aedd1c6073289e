"""Discovery by name: a configuration, a mix, a metric and a cell added as
new files and new entries of BENCHMARK.json are found and run, with no
file of the benchmark edited."""

import hashlib
import json
import shutil

from servebench import harness, testing

NEW_METRIC = '''"""Requests finished in the window."""


def read(run):
    return float(sum(r.finished is not None and run.t0 < r.finished <= run.t1
                     for r in run.client.records))
'''


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "servebench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_found_by_name(tmp_path):
    root = testing.make_root(tmp_path)
    shutil.copytree(testing.REPO / "servebench" / "traffic",
                    root / "servebench" / "traffic", dirs_exist_ok=True)
    before = digest(root)
    sb = root / "servebench"
    conf = testing.tiny_model("tiny-gelu")
    conf.update(name="tiny-wide")
    conf["model"].update(d_model=128, n_heads=8, n_kv_heads=2, d_ff=320)
    (sb / "configs" / "tiny-wide.json").write_text(json.dumps(conf))
    mix = dict(testing.MIX, loop="poisson", rate=40.0,
               output={"dist": "fixed", "value": 6})
    (sb / "traffic" / "burst.json").write_text(json.dumps(mix))
    (sb / "metrics" / "finished_requests.py").write_text(NEW_METRIC)
    (sb / "cells" / "tiny-wide.burst.json").write_text(
        json.dumps({"limits": testing.TINY_LIMITS}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-wide", "source": "x",
                            "file": "servebench/configs/tiny-wide.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny-wide.burst",
                              "config": "tiny-wide", "traffic": "burst",
                              "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "finished_requests", "unit": "1",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["tiny-wide.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    after = digest(root)
    assert all(after[p] == h for p, h in before.items())   # nothing edited
    assert set(after) - set(before) == {
        p.relative_to(root) for p in (
            sb / "configs" / "tiny-wide.json", sb / "traffic" / "burst.json",
            sb / "metrics" / "finished_requests.py",
            sb / "cells" / "tiny-wide.burst.json")}
    names = {m["name"] for m in harness.metrics_for(spec, "tiny-wide.burst",
                                                    False)}
    assert "finished_requests" in names and "ttft_p90_ms" not in names
    out = testing.run_tiny(root, "tiny-wide.burst", seconds=1.5)
    metrics = out["result"]["metrics"]
    assert metrics["finished_requests"]["value"] >= 1
    assert metrics["output_tok_s"]["value"] > 0
    assert out["result"]["correct"]
    assert out["info"]["lag_max_s"] >= 0


def test_closed_loop_keeps_one_request_a_client(tmp_path):
    root = testing.make_root(tmp_path)
    for cell in ("tiny-gelu.shared", "tiny-swiglu.mix"):
        out = testing.run_tiny(root, cell)
        assert out["info"]["most_outstanding"] == testing.MIX["clients"]
        assert out["result"]["attempted"] > testing.MIX["clients"]


def test_traced_run_reports_per_layer_metrics(tmp_path):
    root = testing.make_root(tmp_path)
    out = testing.run_tiny(root, "tiny-gelu.shared", trace=True)
    metrics = out["result"]["metrics"]
    # on the CPU the device's own metrics find nothing to read
    assert {"prefix_hit_share", "prefill_pad_share", "decode_step_ms",
            "prefill_chunk_ms", "mfu", "decode_hbm_share",
            "peak_mem_gib"} == set(metrics)
    assert 0 < metrics["prefix_hit_share"]["value"] < 100
    assert "busy_s" in out["result"]["device"]


def test_moe_cell_found_by_name(tmp_path):
    """A configuration of another family (the port's ``family`` ``moe``)
    and its cell, added as new files and new entries, run correct through the
    family's weights, reference and step costs; no file is edited."""
    root = testing.make_root(tmp_path)
    before = digest(root)
    cell = testing.add_moe(root, "tiny-moe-shared")
    sb = root / "servebench"
    after = digest(root)
    assert all(after[p] == h for p, h in before.items())   # nothing edited
    assert set(after) - set(before) == {
        p.relative_to(root) for p in (
            sb / "configs" / "tiny-moe-shared.json",
            sb / "cells" / f"{cell}.json")}
    out = testing.run_tiny(root, cell)
    assert out["result"]["correct"]
    assert out["info"]["compared_tokens"] >= 40
    traced = testing.run_tiny(root, cell, trace=True)
    metrics = traced["result"]["metrics"]
    # the whole step's shares list no cells: every cell has them, priced
    # by its family
    assert metrics["mfu"]["value"] > 0
    assert metrics["decode_hbm_share"]["value"] > 0
    assert traced["result"]["correct"]
