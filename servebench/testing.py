"""Tiny cells for the CPU tests: a checkout-like directory holding a
``BENCHMARK.json`` with two small configurations (a SwiGLU and a GELU
decoder at the reduced sizes of the port's registry entries), their
mixes, limits, the real metric readers and family modules, and the
program's ``src/`` linked in.  ``run_tiny`` drives ``harness.run_cell``
there on the CPU with the port's plain backends.  ``tiny_moe`` gives a
configuration of the moe family, which a test adds as new files.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Dict

REPO = Path(__file__).resolve().parents[1]
CPU_ENGINE = {"backend": "reference", "attn_backend": "gather"}

TINY_MODELS = {
    # the port's reduced() sizes of the two registry entries
    "tiny-swiglu": ("mistral-large-123b", dict(
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256)),
    "tiny-gelu": ("starcoder2-15b", dict(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=256, vocab_size=256)),
}

TINY_MOE = {
    # the port's reduced() sizes of the two moe registry entries: routed
    # experts alone, and one expert a token beside a shared expert
    "tiny-moe": ("qwen3-moe-235b-a22b", dict(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256, n_experts=8, top_k=2, moe_d_ff=96,
        n_shared_experts=0)),
    "tiny-moe-shared": ("llama4-scout-17b-a16e", dict(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, n_experts=4, top_k=1, moe_d_ff=128,
        n_shared_experts=1)),
}

MIX = {"loop": "closed", "clients": 4, "requests": 64,
       "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.5,
                  "min": 9, "max": 40},
       "output": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                  "min": 4, "max": 24},
       "prefix_cache": False, "profile": {"steps": 6},
       "check_tokens": 400}
SHARED = dict(MIX, prefix_cache=True,
              sharing={"contexts": 3, "zipf": 1.1,
                       "length": {"dist": "uniform", "min": 20, "max": 40}})

# the tiny cells' limits, from readings on five seeds of both tiny models:
# the bf16 program's widest gap 0-0.016 and logit error 0.005-0.011, the
# float8 control's 0.09-0.45 and 0.07-0.17 (test_servebench_control.py)
TINY_LIMITS = {"max_gap": 0.05, "logit_rms_err": 0.03}


def tiny_model(name: str, dtype: str = "bfloat16") -> Dict:
    registry, sizes = TINY_MODELS[name]
    conf = json.loads((REPO / "servebench" / "configs"
                       / f"{registry}.json").read_text())
    conf["name"] = name
    conf["model"].update(sizes, dtype=dtype)
    conf["serve"].update(lanes=4, max_len=128, page_size=4,
                         prefill_chunk=8, cache_tokens=1024)
    return conf


def tiny_moe(name: str, dtype: str = "bfloat16") -> Dict:
    """A moe configuration on the tiny SwiGLU's serving settings, with
    the capacity factor ``n_experts / top_k`` that lets the port drop no
    pair (``families/moe.py``)."""
    registry, sizes = TINY_MOE[name]
    conf = tiny_model("tiny-swiglu", dtype)
    conf.update(name=name, registry=registry)
    conf["model"].update(sizes, family="moe",
                         capacity_factor=sizes["n_experts"] / sizes["top_k"])
    return conf


def make_root(path: Path, dtype: str = "bfloat16") -> Path:
    """A tiny checkout at ``path``: cells ``<model>.mix`` and
    ``<model>.shared`` of both tiny models."""
    sb = path / "servebench"
    for sub in ("configs", "traffic", "cells"):
        (sb / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "families"):
        shutil.copytree(REPO / "servebench" / sub, sb / sub,
                        ignore=shutil.ignore_patterns("__pycache__"),
                        dirs_exist_ok=True)
    if not (path / "src").exists():
        os.symlink(REPO / "src", path / "src")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"], spec["workloads"] = [], []
    for name in TINY_MODELS:
        (sb / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_model(name, dtype)))
        spec["configs"].append({
            "name": name, "source": "https://arxiv.org/abs/2402.19173",
            "file": f"servebench/configs/{name}.json", "reduced": [],
            "why": "tiny"})
        for mix in ("mix", "shared"):
            cell = f"{name}.{mix}"
            spec["workloads"].append({"name": cell, "config": name,
                                      "traffic": mix, "chips": 1,
                                      "why": "tiny"})
            (sb / "cells" / f"{cell}.json").write_text(
                json.dumps({"limits": TINY_LIMITS}))
    cells = [w["name"] for w in spec["workloads"]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            shared = m["name"] in ("ttft_p90_ms", "prefix_hit_share")
            m["workloads"] = [c for c in cells
                              if c.endswith(".shared") or not shared]
    (path / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    (sb / "traffic" / "mix.json").write_text(json.dumps(MIX))
    (sb / "traffic" / "shared.json").write_text(json.dumps(SHARED))
    return path


def add_moe(root: Path, name: str, mix: str = "mix",
            dtype: str = "bfloat16") -> str:
    """Add the tiny moe configuration ``name`` and its cell
    ``<name>.<mix>`` to a tree of :func:`make_root` as new files and new
    entries of its ``BENCHMARK.json``; returns the cell's name."""
    sb = root / "servebench"
    conf = tiny_moe(name, dtype)
    (sb / "configs" / f"{name}.json").write_text(json.dumps(conf))
    cell = f"{name}.{mix}"
    (sb / "cells" / f"{cell}.json").write_text(
        json.dumps({"limits": TINY_LIMITS}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": name, "source": "https://arxiv.org/abs/2505.09388",
        "file": f"servebench/configs/{name}.json", "reduced": [],
        "why": "tiny"})
    spec["workloads"].append({"name": cell, "config": name, "traffic": mix,
                              "chips": 1, "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return cell


class TickClock:
    """A clock that moves ``tick`` seconds at every reading: a window of
    ``seconds`` then holds the same steps however busy the host is."""

    def __init__(self, tick: float = 0.002):
        self.t, self.tick = 0.0, tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


def run_tiny(root: Path, workload: str, seed: int = 1234567890123,
             seconds: float = 1.0, trace: bool = False,
             control: bool = False, hooks=None) -> Dict:
    import torch

    from servebench import harness

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(workload, seed, seconds, trace, root=root,
                                device="cpu", require=False,
                                control=control,
                                engine_overrides=CPU_ENGINE, hooks=hooks,
                                clock=TickClock())
    finally:
        torch.set_num_threads(threads)
