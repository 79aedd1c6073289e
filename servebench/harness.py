"""One run of one cell: set-up, the measured window, the traced span, the
readers, the check and the result line.

Everything is found by name from ``BENCHMARK.json``: the cell names its
configuration (``configs/<config>.json``, the file that ``BENCHMARK.json``
gives) and its traffic mix (``traffic/<mix>.json``); its limits are in
``cells/<workload>.json``; each metric is read by
``metrics/<metric>.py``; the configuration's family (the port's
``ModelConfig.family`` of the file's model) is ``families/<family>.py``,
which draws and packs the weights, scores the check's reference and
prices a token and a decode step.  ``README.md`` gives the formats.

The program under test is the port's ``repro_torch.serve.ServeEngine``;
the harness imports nothing else of it but the config registry and, in a
traced run, the kernels' launch counts (the family module packs the
weights with the port's packing).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# decode steps set-up runs after the lanes fill: the second captures the
# decode graph, the third replays it
WARMUP_DECODE_STEPS = 3
# the numbers the check holds to the cell's limits (``check.py``)
COMPARED = ("max_gap", "logit_rms_err")


class NoChip(RuntimeError):
    """The run found no card, or fewer than the cell asks for."""


# ------------------------------------------------------------------ finding
def load_spec(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(spec: Dict, workload: str) -> Dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(spec: Dict, root: Path, name: str) -> Dict:
    for conf in spec["configs"]:
        if conf["name"] == name:
            return json.loads((root / conf["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix_of(root: Path, name: str) -> Dict:
    return json.loads((root / "servebench" / "traffic"
                       / f"{name}.json").read_text())


def limits_of(root: Path, workload: str) -> Dict:
    return json.loads((root / "servebench" / "cells"
                       / f"{workload}.json").read_text())["limits"]


def metrics_for(spec: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    those that list the cell, or list none."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def _load(path: Path, module: str):
    mod_spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(root: Path, name: str):
    return _load(root / "servebench" / "metrics" / f"{name}.py",
                 f"servebench_metric_{name.replace('.', '_')}").read


def family_module(root: Path, name: str):
    """``families/<name>.py``: its ``build_params``, ``score``,
    ``token_flops`` and ``decode_step_bytes``."""
    return _load(root / "servebench" / "families" / f"{name}.py",
                 f"servebench_family_{name.replace('.', '_')}")


def family_of(root: Path, conf: Dict):
    """The family module of the configuration's family, as the port
    reads it (``port_config(conf).family``)."""
    return family_module(root, port_config(conf).family)


# ------------------------------------------------------------------- set-up
def require_chip(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoChip("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"the cell asks for {chips} cards, the host has "
                     f"{torch.cuda.device_count()}")


def use_checkout(root: Path) -> None:
    """The program from this checkout's ``src/``, and every build or
    kernel cache at a fixed path inside the checkout."""
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        raise FileNotFoundError(f"{src / 'repro_torch'}: the program under "
                                "test is not in this checkout")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def port_config(conf: Dict):
    """The port's ``ModelConfig`` of the registry entry, with the file's
    sizes: the file is what runs."""
    from repro_torch.config.registry import get_arch

    return dataclasses.replace(get_arch(conf["registry"]), **conf["model"])


def build_engine(cfg, conf: Dict, mix: Dict, params, seed: int, device,
                 engine_overrides: Optional[Dict] = None):
    """The paged ``ServeEngine`` of the configuration's serving settings
    on ``device``, graphs on where the device is a card.  The pool holds
    every lane at ``max_len`` plus ``cache_tokens`` for the prefix
    cache."""
    from repro_torch.config.base import EngineConfig, ServeConfig
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.pages import pages_for

    serve = conf["serve"]
    eng_conf = {**conf["engine"], **(engine_overrides or {})}
    engine = EngineConfig(**eng_conf)
    scfg = ServeConfig(engine=engine, mode="paged",
                       page_size=serve["page_size"],
                       prefill_chunk=serve["prefill_chunk"],
                       prefix_cache=bool(mix.get("prefix_cache")))
    page = serve["page_size"]
    n_pages = (serve["lanes"] * pages_for(serve["max_len"], page) + 1
               + pages_for(serve.get("cache_tokens", 0), page))
    return ServeEngine(cfg, params, scfg, n_slots=serve["lanes"],
                       max_len=serve["max_len"], seed=seed,
                       n_pages=n_pages, device=device), serve


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


# --------------------------------------------------------------------- run
def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device=None, control: bool = False,
             t_start: Optional[float] = None, require: bool = True,
             engine_overrides: Optional[Dict] = None,
             hooks=None, clock=None) -> Dict:
    """Run one cell: ``{"result": the contract's line (the check last),
    "info": counts of the window}``; ``device`` None is the first card.
    ``hooks(engine)`` may change the engine before set-up (the tests
    break it with faults);
    ``clock`` replaces the client's host clock (the tests' clock ticks a
    fixed time a reading, so that their windows hold fixed work)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(root)
    cell = cell_of(spec, workload)
    conf = config_of(spec, root, cell["config"])
    mix = mix_of(root, cell["traffic"])
    limits = limits_of(root, workload)
    metrics = metrics_for(spec, workload, trace)
    readers = {m["name"]: reader(root, m["name"]) for m in metrics}
    use_checkout(root)
    family = family_of(root, conf)
    if require:
        require_chip(cell["chips"])
    import torch

    from servebench import check
    from servebench.client import Client
    from servebench.profile import trace_span
    from servebench.traffic import Traffic
    from servebench.window import Run

    on_card = device is None or torch.device(device).type == "cuda"
    device = torch.device("cuda", 0) if device is None else torch.device(
        device)
    if on_card:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    model, engine_conf = conf["model"], conf["engine"]
    bits = engine_conf["weight_bits"]
    cfg = port_config(conf)
    phases = {"import_s": time.perf_counter() - t_start}

    def phase(name, t0):
        if on_card:
            torch.cuda.synchronize(device)
        phases[name] = time.perf_counter() - t0

    with torch.no_grad():
        t0 = time.perf_counter()
        params = family.build_params(cfg, model, bits, seed, device)
        phase("weights_s", t0)
        t0 = time.perf_counter()
        eng, serve = build_engine(cfg, conf, mix, params, seed, device,
                                  engine_overrides)
        del params
        if hooks is not None:
            hooks(eng)
        traffic = Traffic(mix, model["vocab_size"], serve["max_len"], seed)
        cli = Client(eng, traffic, clock=clock or time.perf_counter)
        phase("engine_s", t0)
        t0 = time.perf_counter()
        cli.warm_up(WARMUP_DECODE_STEPS)
        phase("warm_up_s", t0)
        phases["capture_s"] = eng.capture_seconds
        setup_s = time.perf_counter() - t_start
        window = cli.run_window(seconds)
        profile = trace_span(cli, mix["profile"]) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run = Run(cli, window, model, engine_conf, serve, setup_s, peak, profile,
              family)
    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = len(cli.attempted)
    failed = sum(getattr(r.req, "finish_reason", None) not in (None, "length")
                 for r in cli.attempted)
    w0, w1 = window["t0"], window["t1"]
    sampled = check.sample(cli.records, w0, w1, seed, mix["check_tokens"])
    chosen = [SimpleNamespace(req=SimpleNamespace(
        prompt=list(r.req.prompt), output=list(r.req.output[:served])),
        rows=check.kept_rows(r, cli.logits, served))
        for r, served in sampled]
    running = check.running_at_close(cli.records, w0, w1)
    info = {"window_s": run.seconds, "steps": len(run.steps),
            "chunk_steps": sum(s.chunk for s in run.steps),
            "finished": len(check.finished_in_window(cli.records, w0, w1)),
            "running_at_close": len(running),
            "compared_running": sum(any(r is x for x in running)
                                    for r, _ in sampled),
            "lag_max_s": max((r.sent - r.due for r in cli.attempted),
                             default=0.0),
            "most_outstanding": cli.most_live,
            "logit_rows_kept": cli.n_logits,
            "pool": _pool_counts(eng)}
    # the program's state goes before the reference runs
    del eng, cli, run, sampled, running
    gc.collect()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = (check.compare(family, model, engine_conf, seed, chosen,
                             device, control=control) if chosen else {})
    info["compared_tokens"] = numbers.get("compared_tokens", 0)
    info["reference_s"] = time.perf_counter() - t0
    info["setup"] = phases
    checked = {
        "served_requests": {"value": len(chosen), "limit": ">= 1"},
        "failed_requests": {"value": failed, "limit": 0},
        "logit_rows": {"value": numbers.get("logit_rows", 0),
                       "limit": ">= 1"},
    }
    for name in COMPARED:
        checked[name] = {"value": numbers.get(name), "limit": limits[name]}
    if control:
        for name in COMPARED:
            checked[f"control_{name}"] = {
                "value": numbers.get(f"control_{name}"),
                "limit": limits[name]}
    correct = bool(chosen) and failed == 0 and (
        numbers["logit_rows"] >= 1) and all(
        numbers[name] <= limits[name] for name in COMPARED)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values,
              "device": _device_block(torch, device, on_card, cell["chips"],
                                      peak, profile)}
    if profile:
        result["breakdown"] = {"device_ops": profile.get("device_ops", []),
                               "idle_gaps": profile.get("idle_gaps", [])}
        _write_profile(root, workload, seed, profile)
    result["check"] = checked
    return {"result": result, "info": info}


def _pool_counts(eng) -> Dict[str, int]:
    """The K/V pool at the window's close: its pages, those free, and
    the prefix cache's resident and evicted pages."""
    stats = eng.prefix_stats() or {}
    return {"pages": eng.alloc.n_pages, "free": eng.alloc.free_pages,
            "cached": stats.get("cached_pages", 0),
            "evicted": stats.get("evicted_pages", 0)}


def _write_profile(root: Path, workload: str, seed: int,
                   profile: Dict) -> None:
    out = root / "build" / "servebench" / workload / f"seed-{seed}"
    out.mkdir(parents=True, exist_ok=True)
    keep = {k: v for k, v in profile.items() if k != "steps"}
    keep["steps"] = [dataclasses.asdict(s) for s in profile["steps"]]
    (out / "profile.json").write_text(json.dumps(keep))


def _device_block(torch, device, on_card, chips, peak, profile) -> Dict:
    block = {"platform": "gpu" if on_card else device.type,
             "kind": (torch.cuda.get_device_name(device) if on_card
                      else "cpu"),
             "count": chips, "memory_peak_bytes": int(peak)}
    if profile is not None:
        block["busy_s"] = profile.get("busy_s", 0.0)
        block["window_s"] = profile.get("window_s", 0.0)
    return block


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control (calibration only)")
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), control=bool(args.control),
                       t_start=t_start)
    except NoChip as exc:
        print(f"servebench: {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"servebench: the run loaded {found}; the port must not load "
              "JAX or the JAX package", file=sys.stderr)
        return 3
    result = out["result"]
    print(json.dumps({"info": out["info"]}))
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(f"check correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
