#!/usr/bin/env python3
"""Where the time of the SSD scan goes, on one NVIDIA GPU.

Builds ``src/repro_torch/csrc/ssd_scan.cu`` once as it is and once for each
part of its bfloat16 output pass (``ssd_output_wgmma_kernel``) left out,
through the source's ``SSD_ABLATE_*`` switches: the inter-chunk term (``C . h``), the C B^T
tiles, their decay, the products of the decayed tiles with xdt, the
copies of the B / xdt tiles.  Each copy is its own shared library, built
with the package's nvcc flags (``repro_torch.kernels._build.NVCC_FLAGS``).
At the ``ssm`` shape of ``chip_smoke.py`` (B 4, S 4096, H 24, P 64, N 128,
chunk 256, bf16) it times each copy's whole call (CUDA events over calls
that rotate input copies beyond L2, as ``chip_smoke.py`` times), and the
whole copy's three kernels one by one
(``torch.profiler``).  A copy without a part computes a wrong result: only
its time is read.  Run from the root of a checkout::

    python3 ssd_ablation.py [--out DIR]

It prints the card's name and power limit, then one JSON line with the
milliseconds of each variant and one with the kernels' microseconds.
Libraries go to ``build/ssd_ablation`` (``.gitignore`` lists ``build/``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "ssd_scan.cu"

VARIANTS = {
    "whole": [],
    "no_inter": ["SSD_ABLATE_INTER"],
    "no_cbt": ["SSD_ABLATE_G"],
    "no_decay": ["SSD_ABLATE_DECAY"],
    "no_intra_products": ["SSD_ABLATE_PV"],
    "no_tile_copies": ["SSD_ABLATE_COPY"],
}


def build(out: Path):
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, macros in VARIANTS.items():
        cmd = [nvcc, *_build.NVCC_FLAGS, *[f"-D{m}" for m in macros],
               "-shared", str(SOURCE), "-o", str(out / f"{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).imagine_ssd_scan
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "ssd_ablation"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    entries = build(Path(args.out))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 6)
    inputs = cs.ssd_inputs(torch, dev, gen)
    sh, chunk = cs.SSD_SHAPE, 256
    b, s, nh, p, n = sh["b"], sh["s"], sh["h"], sh["p"], sh["n"]
    nc = s // chunk
    n_bytes = sum(t.numel() * t.element_size() for t in inputs)
    sets = [tuple(t.clone() for t in inputs)
            for _ in range(cs.n_copies(n_bytes))]

    def caller(fn):
        def call(xdt, la, b_in, c_in):
            y = torch.empty((b, s, nh, p), dtype=torch.float32, device=dev)
            h = torch.empty((b, nh, p, n), dtype=torch.float32, device=dev)
            st = torch.empty((b, nc, nh, p, n), dtype=torch.float32,
                             device=dev)
            enter = torch.empty((b, nc, nh, 2, p, n), dtype=torch.bfloat16,
                                device=dev)
            tot = torch.empty((b, nc, nh), dtype=torch.float32, device=dev)
            err = fn(xdt.data_ptr(), la.data_ptr(), b_in.data_ptr(),
                     c_in.data_ptr(), y.data_ptr(), h.data_ptr(),
                     st.data_ptr(), enter.data_ptr(), tot.data_ptr(), b, s,
                     nh, p, n, chunk, 1,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"cudaError {err}")
            return y
        return call

    row = dict(shape=sh, chunk=chunk)
    for name, fn in entries.items():
        row[name] = cs.timed_ms(caller(fn), sets, torch)
    print(json.dumps(row), flush=True)
    call = caller(entries["whole"])
    for args_ in sets[:3]:
        call(*args_)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for args_ in sets[:10]:
            call(*args_)
        torch.cuda.synchronize()
    kernels = {e.key.split("<")[0].split("::")[-1]:
               e.device_time_total / e.count
               for e in prof.key_averages() if e.device_time_total > 0}
    print(json.dumps(dict(kernel_us=kernels)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
