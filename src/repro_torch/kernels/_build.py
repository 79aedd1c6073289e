"""Build and bind the port's CUDA kernels.

The sources in ``repro_torch/csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a`` at first use: one ``nvcc -c`` per source, all started together,
then one link into ``build/kernels/libimagine_kernels.so`` at the root of
the checkout (``.gitignore`` lists ``build/``).  The library is rebuilt
when the hash of the flags or of any file under ``csrc/`` (sources and
the headers they share) changes.  It has a plain C interface, bound with
``ctypes`` by each kernel's ``kernel.py``.

Nothing here runs at import time: a host without ``nvcc`` imports the
package, and only a launch on a CUDA tensor builds.

``LAUNCHES`` counts kernel launches by name, and ``ROUTE_LAUNCHES`` by
``"<kernel>/<route>"`` for the kernels with more than one design
(``ROUTES``; see ``count``).  Each wrapper adds one where it launches its
kernel and nowhere else, so a run can show that its path went through the
kernels.  ``BALANCED_LAUNCHES`` is a plain count of the GEMVs' dense
decode-route launches, every one of which runs the balanced schedule of
``csrc/gemv_decode.cuh`` (``count_balanced``), kept beside the route
counts and not among their keys.  A CUDA graph replays launches without
running the wrappers: its capture runs them once, inside ``recording``,
which takes those counts back out and hands them over (the balanced count
under ``BALANCED``), and every replay adds them with ``add_launches``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libimagine_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {
    "bitplane_gemv": 0,
    "paged_decode_attention": 0,
    "paged_prefill_attention": 0,
    "flash_attention": 0,
    "ssd_scan": 0,
    "int8_matvec": 0,
}

# the designs of the kernels that have more than one: the GEMVs' picked by
# M and the type of x (_gemv.route, _gemv.grouped_route), flash and
# chunked-prefill attention's by dtype (flash_attention.kernel.route,
# paged_attention.kernel.prefill_route), and flash attention's past head
# dim 256 (``wide``, the design that streams D)
GEMV_ROUTES = ("decode", "rows", "tensor_core")
# the bit-plane GEMV's expert-grouped launch (stacked MoE experts), the same
# three designs picked by the static bound on an expert's rows
GROUPED_ROUTES = tuple(f"grouped_{r}" for r in GEMV_ROUTES)
ATTENTION_ROUTES = ("cuda_core", "tensor_core")
ROUTES: Dict[str, Tuple[str, ...]] = {
    "bitplane_gemv": GEMV_ROUTES + GROUPED_ROUTES,
    "int8_matvec": GEMV_ROUTES,
    "flash_attention": ATTENTION_ROUTES + ("wide",),
    "paged_prefill_attention": ATTENTION_ROUTES,
}
ROUTE_LAUNCHES: Dict[str, int] = {
    f"{kernel}/{route}": 0
    for kernel, routes in ROUTES.items() for route in routes}
# dense decode-route launches (either GEMV) on the balanced schedule, and
# their key in a graph's ``recording`` delta
BALANCED_LAUNCHES = 0
BALANCED = "balanced_decode"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global BALANCED_LAUNCHES
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0
    BALANCED_LAUNCHES = 0


def count(kernel: str, route: Optional[str] = None) -> None:
    """One launch of ``kernel`` (through ``route``, for the kernels of
    ``ROUTES``)."""
    LAUNCHES[kernel] += 1
    if route is not None:
        ROUTE_LAUNCHES[f"{kernel}/{route}"] += 1


def count_balanced() -> None:
    """One dense decode-route launch on the balanced schedule."""
    global BALANCED_LAUNCHES
    BALANCED_LAUNCHES += 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Launches counted inside the block are taken back out of the counts
    and left in the yielded dictionary instead (``LAUNCHES`` names,
    ``ROUTE_LAUNCHES`` names with their ``/``, and ``BALANCED``): a CUDA
    graph's capture records launches that run only when the graph is
    replayed."""
    global BALANCED_LAUNCHES
    before = (dict(LAUNCHES), dict(ROUTE_LAUNCHES))
    balanced = BALANCED_LAUNCHES
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        for counts, old in zip((LAUNCHES, ROUTE_LAUNCHES), before):
            for name, n in counts.items():
                if n != old[name]:
                    delta[name] = n - old[name]
                    counts[name] = old[name]
        if BALANCED_LAUNCHES != balanced:
            delta[BALANCED] = BALANCED_LAUNCHES - balanced
            BALANCED_LAUNCHES = balanced


def add_launches(delta: Dict[str, int]) -> None:
    """Count the launches of one replay of a graph (``recording``'s
    dictionary)."""
    global BALANCED_LAUNCHES
    for name, n in delta.items():
        if name == BALANCED:
            BALANCED_LAUNCHES += n
        else:
            (ROUTE_LAUNCHES if "/" in name else LAUNCHES)[name] += n


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if autograd would record a launch: grad mode is on and an
    input requires grad.  The kernels write their outputs through raw
    pointers and have no backward pass, so a tensor they return has no
    history; training runs the plain paths (``attn_backend="gather"``,
    float weights).  The caller neither detaches nor falls back."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the CUDA kernel has no "
            "backward pass; run it under torch.no_grad(), or train on the "
            "plain path (attn_backend='gather', float weights)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.iterdir()
                       if p.suffix in (".cu", ".cuh", ".h")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            "repro_torch/csrc at first use and need the CUDA toolkit")
    return nvcc


def build() -> Dict[str, object]:
    """Compile and link the kernel library unless an up-to-date one exists.

    Returns ``{"path", "seconds", "log"}``: ``seconds`` is None when the
    library was already current; ``log`` holds the compilers' output
    (``-Xptxas -v`` register and shared-memory counts).  Raises
    ``RuntimeError`` with the compiler's output when a step fails.
    """
    digest = _digest()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return {"path": lib, "seconds": None, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{digest[:12]}.{os.getpid()}"
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(
            f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", *[str(o) for o in objs], "-o", str(tmp)],
        capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    stamp.write_text(digest)
    log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(log)
    return {"path": lib, "seconds": time.perf_counter() - t0, "log": log}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()["path"]))
        return _lib
