#!/usr/bin/env python3
"""Where the time of the GEMV's tensor-core tile goes, on one NVIDIA GPU.

Builds ``src/repro_torch/csrc/bitplane_gemv.cu`` once as it is and once for
each part of its tensor-core tile (``csrc/tc_gemm.cuh``) left out, through
the header's ``TC_ABLATE_*`` switches: the consumers' reads and decode of
the packed rows into A registers, the wgmma products, the epilogue.  Each
copy is its own shared library, built with the package's nvcc flags
(``repro_torch.kernels._build.NVCC_FLAGS``).  It times each copy's
``imagine_bitplane_gemv_tc`` beside ``torch.matmul`` on the dequantized
bf16 weight, at the shapes of the main paths' prefills.  A copy without a
part computes a wrong result: only its time is read.  Run from the root of
a checkout::

    python3 tc_gemm_ablation.py [--bits 4] [--out DIR]

It prints the card's name and power limit, then one JSON line per shape
(milliseconds per variant, CUDA events over launches that rotate weight
copies beyond L2, as ``chip_smoke.py`` times).  Libraries go to
``build/ablation`` (``.gitignore`` lists ``build/``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "bitplane_gemv.cu"

VARIANTS = {
    "whole": [],
    "no_decode": ["TC_ABLATE_DECODE"],
    "no_mma": ["TC_ABLATE_MMA"],
    "copies_and_epilogue": ["TC_ABLATE_DECODE", "TC_ABLATE_MMA"],
    "no_epilogue": ["TC_ABLATE_EPILOGUE"],
}
# (M, K, N): the long prefill's w_gate/w_up and wk/wv, the paged prefill
# chunk's w_gate/w_up, mamba2-130m's in_proj at the ssm prefill
SHAPES = [(8192, 2048, 11008), (8192, 2048, 256), (256, 2048, 11008),
          (16384, 768, 3352)]


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
        fn = ctypes.CDLL(str(out / f"{name}.so")).imagine_bitplane_gemv_tc
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=4, choices=(2, 4, 8))
    ap.add_argument("--out", default=str(ROOT / "build" / "ablation"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tc_gemm_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core import unpack_weights
    from repro_torch.kernels._gemv import tc_partial

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    entries = build(Path(args.out))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in SHAPES:
        packed, scale, x = cs.gemv_case(torch, dev, gen, args.bits, k, n, m,
                                        torch.bfloat16)
        splits = tc_partial(m, n, k, dev)[0]
        row = dict(m=m, k=k, n=n, bits=args.bits, splits=splits)
        packs = [(packed.clone(),)
                 for _ in range(cs.n_copies(k * n * args.bits // 8))]
        for name, fn in entries.items():
            def call(p, fn=fn, name=name):
                out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                _, part = tc_partial(m, n, k, dev)
                err = fn(p.data_ptr(), scale.data_ptr(), x.data_ptr(),
                         out.data_ptr(),
                         None if part is None else part.data_ptr(), m, k, n,
                         args.bits, splits, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
                return out
            row[name] = cs.timed_ms(call, packs, torch)
        w = (unpack_weights(packed, args.bits).float() * scale).bfloat16()
        row["torch.matmul"] = cs.timed_ms(
            lambda ww: torch.matmul(x, ww),
            [(w.clone(),) for _ in range(cs.n_copies(w.numel() * 2))], torch)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
