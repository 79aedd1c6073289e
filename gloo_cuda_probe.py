#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives a ``gloo`` group takes on CUDA
tensors, and what one costs against the same call staged through host
memory (``repro_torch.dist.collectives``' transport on one card).

Run from the root of a checkout, on a machine with a CUDA device::

    python3 gloo_cuda_probe.py

It starts two processes on device 0 that form a ``gloo`` group through a
file store under ``build/``, calls each collective on a small CUDA tensor,
and prints one JSON line per collective (``ok``, or the error's first
line), then the host milliseconds of an ``all_reduce`` of a decode step's
partial sum (8 x 2048 float32) and of a prefill chunk's (256 x 2048),
taken directly on the CUDA tensor and staged through host memory.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def rank_main(rank: int, work: Path) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(work / "store"), 2), rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    x = torch.full((4, 8), float(rank + 1), device=dev)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(2)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty((8, 8), device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty((2, 8), device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "reduce": lambda: dist.reduce(x.clone(), 0),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:   # the probe reports what gloo refuses
            out[name] = str(e).splitlines()[0][:200]
    for rows in (8, 256):
        t = torch.randn((rows, 2048), device=dev)
        times = {}
        for mode in ("direct", "staged"):
            for _ in range(3):
                _all_reduce(dist, t, mode)
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(20):
                _all_reduce(dist, t, mode)
            torch.cuda.synchronize()
            times[mode] = 1e3 * (time.perf_counter() - t0) / 20
        out[f"all_reduce_{rows}x2048_f32_ms"] = times
    if rank == 0:
        for name, res in out.items():
            print(json.dumps({"collective": name, "result": res}),
                  flush=True)
    dist.barrier()
    dist.destroy_process_group()


def _all_reduce(dist, t, mode):
    if mode == "direct":
        dist.all_reduce(t)
    else:
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    work = ROOT / "build" / "gloo_probe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               str(work)]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(json.dumps({"torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0),
                      "rcs": rcs}), flush=True)
    return max(rcs)


if __name__ == "__main__":
    if "--rank" in sys.argv:
        rank_main(int(sys.argv[2]), Path(sys.argv[3]))
        sys.exit(0)
    sys.exit(main())
