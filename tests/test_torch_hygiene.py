"""Rules of the PyTorch port that no parity test would catch.

* ``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor the JAX
  package ``repro``; importing every module of the port leaves both (and
  ``triton``) out of ``sys.modules`` and builds no kernel.
* Entry points run on the GPU unless told otherwise: with no device on a
  host without CUDA they raise instead of carrying on on the CPU.
* The ``ops`` wrappers run the plain versions (``ref.py``) for CPU tensors
  only; a tensor on any other device goes to the kernel's launcher, which
  launches or raises.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.kernels.bitplane_gemv import ops as gemv_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.int8_matvec import ops as int8_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert all(f.exists() for f in files)
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    mods = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.kernels import _build\n"
        "print(json.dumps({'mods': sorted(k.split('.')[0] for k in "
        "sys.modules), 'lib': _build._lib is None}))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    for name in FORBIDDEN + ("triton",):
        assert name not in rec["mods"], name
    assert rec["lib"], "a kernel library was loaded at import time"


def test_entry_points_raise_without_a_gpu(monkeypatch):
    import numpy as np

    from repro_torch import paper_demo
    from repro_torch.config import get_reduced
    from repro_torch.core import gemv, quantize_linear
    from repro_torch.serve import ServeEngine, init_kv_pages
    from repro_torch.weights import params_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(get_reduced("qwen2.5-3b"), {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"layers": {}}, get_reduced("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_kv_pages(get_reduced("qwen2.5-3b"), 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_demo.run(16)
    # a tensor keeps its device; an array goes to the GPU
    ql = quantize_linear(torch.ones((16, 4)), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gemv(ql, np.ones(16, dtype=np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize_linear(np.ones((16, 4), dtype=np.float32), 8)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def _sentinel(*args, **kwargs):
    raise AssertionError("the plain version ran for a non-CPU tensor")


def test_wrappers_never_run_the_plain_version_off_the_cpu(monkeypatch):
    monkeypatch.setattr(gemv_ops, "bitplane_gemv_ref", _sentinel)
    monkeypatch.setattr(pa_ops, "paged_attention_ref", _sentinel)
    monkeypatch.setattr(pa_ops, "paged_prefill_ref", _sentinel)
    meta = torch.device("meta")
    packed = torch.empty((8, 4), dtype=torch.int8, device=meta)
    scale = torch.empty((1, 4), dtype=torch.float32, device=meta)
    x = torch.empty((2, 16), dtype=torch.float32, device=meta)
    with pytest.raises(ValueError, match="not a CUDA device"):
        gemv_ops.bitplane_gemv(packed, scale, x, bits=4)
    q = torch.empty((2, 1, 4, 8), device=meta)
    pool = torch.empty((5, 4, 2, 8), device=meta)
    bt = torch.ones((2, 2), dtype=torch.int32, device=meta)
    pos = torch.zeros((2,), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        pa_ops.paged_attention(q, pool, pool, bt, pos)
    with pytest.raises(ValueError, match="CUDA device"):
        pa_ops.paged_prefill_attention(q, pool, pool, bt, pos, pos + 1)


def test_int8_wrapper_never_runs_the_plain_version_off_the_cpu(monkeypatch):
    monkeypatch.setattr(int8_ops, "int8_matvec_ref", _sentinel)
    meta = torch.device("meta")
    q = torch.empty((16, 4), dtype=torch.int8, device=meta)
    scale = torch.empty((1, 4), dtype=torch.float32, device=meta)
    for x in (torch.empty((16,), device=meta),
              torch.empty((2, 3, 16), device=meta)):
        with pytest.raises(ValueError, match="not a CUDA device"):
            int8_ops.int8_matvec(q, scale, x)


def test_sequence_wrappers_never_run_the_plain_version_off_the_cpu(
        monkeypatch):
    monkeypatch.setattr(flash_ops, "flash_attention_ref", _sentinel)
    monkeypatch.setattr(ssd_ops, "ssd_scan_ref", _sentinel)
    meta = torch.device("meta")
    q = torch.empty((1, 8, 4, 64), device=meta)
    kv = torch.empty((1, 8, 2, 64), device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_ops.flash_attention(q, kv, kv)
    xdt = torch.empty((1, 8, 2, 64), device=meta)
    la = torch.empty((1, 8, 2), device=meta)
    bc = torch.empty((1, 8, 64), device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_ops.ssd_scan(xdt, la, bc, bc, chunk=8)


def test_full_sequence_entry_points_raise_without_a_gpu(monkeypatch):
    from repro_torch.config import get_reduced
    from repro_torch.models import init_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("qwen2.5-3b", "mamba2-130m"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_cache(get_reduced(arch), 1, 8)
