"""Rules of the PyTorch port that no parity test would catch.

* ``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor the JAX
  package ``repro``; importing every module of the port leaves both (and
  ``triton``) out of ``sys.modules`` and builds no kernel.
* Entry points run on the GPU unless told otherwise: with no device on a
  host without CUDA they raise instead of carrying on on the CPU.
* The ``ops`` wrappers run the plain versions (``ref.py``) for CPU tensors
  only; a tensor on any other device goes to the kernel's launcher, which
  launches or raises.
* The kernel library is rebuilt when any source or shared header under
  ``csrc/`` changes, and launches are counted by kernel and by route.
* No launcher reads device data back to the host (``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``): grids and splits follow from
  shapes, so a launch never waits on the card and can be captured in a
  CUDA graph.  The SSD scan's launcher, which runs three kernels and
  allocates their scratch, is also run with its C entry point replaced by
  a recorder and every host read of a tensor made to raise.
* The modules a captured serving step runs (``models/{transformer,
  attention,layers,ssm}.py``, ``engine/{plan,backends}.py``) build no
  device tensor from host data and read nothing back: a CUDA graph
  capture fails on a host-to-device copy or a host sync.  Checked in
  their source, and by running the steps on the CPU with every such call
  made to raise.
* The two GEMVs share one decode source: ``csrc/gemv_decode.cuh`` holds
  the decode kernels, both ``bitplane_gemv.cu`` and ``int8_matvec.cu``
  include it and launch ``dec::launch``, and ``int8_matvec.cu`` defines no
  decode kernel of its own.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.kernels import _build
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


HOST_READS = ("item", "tolist", "cpu", "numpy")


@pytest.mark.parametrize(
    "path", sorted((PORT / "kernels").rglob("*.py")),
    ids=lambda p: str(p.relative_to(PORT)))
def test_launchers_read_nothing_back_from_the_device(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(node.func.attr, node.lineno) for node in ast.walk(tree)
           if isinstance(node, ast.Call)
           and isinstance(node.func, ast.Attribute)
           and node.func.attr in HOST_READS]
    assert not bad, f"{path.relative_to(PORT)} reads back {bad}"


STEP_MODULES = ("models/transformer.py", "models/attention.py",
                "models/layers.py", "models/ssm.py", "engine/plan.py",
                "engine/backends.py")
HOST_DATA = ("tensor", "as_tensor", "asarray", "from_numpy")
HOST_SYNCS = HOST_READS + ("nonzero", "masked_select", "cuda",
                           "synchronize")


def _host_traffic(tree):
    """Calls of a module that would copy host data to the device or wait
    on it: ``torch.tensor`` and its kin, host reads and syncs, and ``.to``
    / ``.copy_`` with a device."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        attr, owner = node.func.attr, node.func.value
        if (attr in HOST_DATA and isinstance(owner, ast.Name)
                and owner.id == "torch"):
            yield f"torch.{attr}", node.lineno
        elif attr in HOST_SYNCS:
            yield attr, node.lineno
        elif attr in ("to", "copy_") and (
                any(k.arg == "device" for k in node.keywords)
                or any("device" in ast.unparse(a) or (
                    isinstance(a, ast.Constant) and a.value in ("cpu",
                                                                "cuda"))
                       for a in node.args)):
            yield f".{attr}(device)", node.lineno


def test_host_traffic_check_flags_the_old_neg_inf():
    old = ("def _neg_inf(device):\n"
           "    return torch.tensor(NEG_INF, dtype=torch.float32, "
           "device=device)\n")
    assert list(_host_traffic(ast.parse(old))) == [("torch.tensor", 2)]
    moved = "y = x.to(q.device)\nz = x.to(torch.float32)\nw = m.nonzero()\n"
    assert list(_host_traffic(ast.parse(moved))) == [(".to(device)", 1),
                                                     ("nonzero", 3)]


@pytest.mark.parametrize("name", STEP_MODULES)
def test_step_modules_build_nothing_from_host_data(name):
    path = PORT / name
    bad = list(_host_traffic(ast.parse(path.read_text(), filename=str(path))))
    assert not bad, f"{name} moves host data or syncs: {bad}"


def _tiny(arch):
    import dataclasses

    from repro_torch.config import get_reduced
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         engine_bits=4)
    return cfg, params


@pytest.mark.parametrize("step", ["decode_step_paged", "prefill_chunk",
                                  "decode_step_dense", "decode_step_ssm"])
def test_steps_move_no_host_data(monkeypatch, step):
    """The steps a graph captures run on the CPU with every call that
    builds a tensor from host data or reads one back made to raise."""
    from repro_torch.models import (
        decode_step,
        decode_step_paged,
        init_cache,
        prefill_chunk,
    )
    from repro_torch.serve import LaneTables, init_kv_pages

    arch = "mamba2-130m" if step.endswith("ssm") else "qwen2.5-3b"
    cfg, params = _tiny(arch)
    b, chunk = 2, 4
    lanes = LaneTables(b, "cpu", max_blocks=4, chunk=chunk)
    lanes.load(block_tables=np.array([[1, 2, 0, 0], [3, 0, 0, 0]]),
               pos=np.array([5, 2]), active=np.array([True, False]),
               pos0=np.array([0, 1]), seq_lens=np.array([4, 3]))
    if step.startswith("decode_step_") and step != "decode_step_paged":
        cache = init_cache(cfg, b, 8, device="cpu")
    else:
        pages = init_kv_pages(cfg, 5, 4, kv_bits=8, device="cpu")

    def host_data(*args, **kwargs):
        raise AssertionError(f"{step} moved host data or read a tensor "
                             "back")

    for name in HOST_DATA:
        monkeypatch.setattr(torch, name, host_data)
    for name in ("item", "tolist", "cpu", "numpy", "nonzero", "__bool__",
                 "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_data)
    if step == "decode_step_paged":
        out = decode_step_paged(params, pages, lanes.block_tables, lanes.pos,
                                lanes.active, lanes.tokens, cfg)
    elif step == "prefill_chunk":
        out = prefill_chunk(params, pages, lanes.block_tables,
                            lanes.chunk_tokens, lanes.pos0, lanes.seq_lens,
                            cfg)
    else:
        out, _ = decode_step(params, cache, lanes.tokens, cfg,
                             active=lanes.active)
    assert out.shape == (b, 1, cfg.vocab_size)


def test_build_digest_covers_sources_and_headers(tmp_path, monkeypatch):
    """A change to a header shared by two sources must rebuild the library,
    or a card run would time a stale one."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "shared.cuh"\n')
    (csrc / "b.cu").write_text('#include "shared.cuh"\n#include "util.h"\n')
    (csrc / "shared.cuh").write_text("constexpr int TILE = 128;\n")
    (csrc / "util.h").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build._sources()] == ["a.cu", "b.cu"]
    first = _build._digest()
    assert _build._digest() == first
    (csrc / "shared.cuh").write_text("constexpr int TILE = 256;\n")
    second = _build._digest()
    assert second != first
    (csrc / "util.h").write_text("#pragma once\n// changed\n")
    third = _build._digest()
    assert third not in (first, second)
    (csrc / "notes.txt").write_text("not a source")
    assert _build._digest() == third


def test_launch_counts_by_kernel_and_route(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(_build, "ROUTE_LAUNCHES", dict(_build.ROUTE_LAUNCHES))
    _build.reset_launches()
    counted = (("bitplane_gemv", "tensor_core"), ("int8_matvec", "decode"),
               ("flash_attention", "tensor_core"),
               ("paged_prefill_attention", "cuda_core"))
    for kernel, route in counted:
        _build.count(kernel, route)
    _build.count("ssd_scan")
    _build.count("paged_decode_attention")
    for kernel in ("bitplane_gemv", "int8_matvec", "flash_attention",
                   "paged_prefill_attention", "ssd_scan",
                   "paged_decode_attention"):
        assert _build.LAUNCHES[kernel] == 1
    assert _build.ROUTE_LAUNCHES == {
        f"{k}/{r}": int((k, r) in counted)
        for k, routes in _build.ROUTES.items() for r in routes}
    assert set(_build.ROUTES["flash_attention"]) == {"cuda_core",
                                                     "tensor_core"}
    assert (_build.ROUTES["paged_prefill_attention"]
            == _build.ROUTES["flash_attention"])
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values())
    assert not any(_build.ROUTE_LAUNCHES.values())


def test_ssd_launcher_reads_nothing_back(monkeypatch):
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    calls = []

    def entry():
        def call(*args):
            calls.append(args)
            return 0
        return call

    class Stream:
        cuda_stream = 0

    def host_read(*args, **kwargs):
        raise AssertionError("the SSD launcher read a tensor on the host")

    monkeypatch.setattr(ssd_kernel, "_check", lambda *a: None)
    monkeypatch.setattr(ssd_kernel, "_entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", host_read)
    monkeypatch.setattr(ssd_kernel._build, "LAUNCHES",
                        dict(ssd_kernel._build.LAUNCHES))
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    bsz, s, nh, p, n = 2, 600, 4, 64, 128
    xdt = torch.zeros((bsz, s, nh, p), dtype=torch.bfloat16)
    la = torch.zeros((bsz, s, nh))
    bc = torch.zeros((bsz, s, n), dtype=torch.bfloat16)
    y, h = ssd_kernel.ssd_scan_cuda(xdt, la, bc, bc, chunk=300)
    assert y.shape == (bsz, s, nh, p) and h.shape == (bsz, nh, p, n)
    (args,) = calls
    # 9 pointers (inputs, outputs, the three scratch tensors), then B, S,
    # H, P, N, the kernels' chunk (cut to 256), the dtype, the stream
    assert all(isinstance(a, int) for a in args[:9])
    assert args[9:] == (bsz, s, nh, p, n, 256, 1, 0)
    assert ssd_kernel._build.LAUNCHES["ssd_scan"] == 1


CSRC = PORT / "csrc"


def _kernels_defined(text: str):
    """Names of the ``__global__`` functions a CUDA source defines."""
    import re

    bounds = r"(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
    return re.findall(r"__global__\s+void\s+" + bounds + r"(\w+)\s*\(",
                      text)


def test_gemvs_share_one_decode_source():
    header = (CSRC / "gemv_decode.cuh").read_text()
    assert "namespace dec" in header
    assert {"decode_mma_kernel", "decode_fma_kernel"} <= set(
        _kernels_defined(header))
    for name in ("bitplane_gemv.cu", "int8_matvec.cu"):
        text = (CSRC / name).read_text()
        assert '#include "gemv_decode.cuh"' in text, name
        assert "namespace dec" not in text, name
        assert "dec::launch<" in text, name
        assert not [k for k in _kernels_defined(text) if "decode" in k], name
    int8 = (CSRC / "int8_matvec.cu").read_text()
    assert _kernels_defined(int8) == ["int8_matvec_kernel"]
    assert "dec::launch<8>" in int8
