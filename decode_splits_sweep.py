#!/usr/bin/env python3
"""Time the bit-plane GEMV's decode route for every K split a cluster takes.

Run from the root of a checkout on one NVIDIA GPU::

    python3 decode_splits_sweep.py

For the decode steps' shapes (M = 8 at qwen2.5-3b's four linears, 4 bits,
bf16 x; M = 1 float32 at 8 bits, d = 2048 and 1983, the engine phase's) it
times the route (``bitplane_gemv_cuda``, CUDA events over launches that
rotate weight copies beyond L2, as ``chip_smoke.py`` times) at every split
count 1 .. 8 that leaves no split without K, by handing the launcher that
count in place of ``_gemv.decode_splits``.  It prints the card's name and
power limit and one JSON line per shape: milliseconds by split count, and
the count ``decode_splits`` picks.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_splits_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    from repro_torch.kernels import _gemv
    from repro_torch.kernels.bitplane_gemv import kernel as gk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda")
    picked = gk.decode_splits
    cases = [(8, k, n, 4, torch.bfloat16) for k, n in c.GEMV_SHAPES]
    cases += [(1, d, d, 8, torch.float32) for d in (2048, 1983)]
    for m, k, n, bits, dt in cases:
        gen = torch.Generator(device=dev).manual_seed(m + k + n)
        packed, scale, x = c.gemv_case(torch, dev, gen, bits, k, n, m, dt)
        packs = [(packed.clone(),) for _ in
                 range(c.n_copies(k * n * bits // 8))]
        k_steps = math.ceil(k / _gemv.DECODE_K_STEP)
        ms = {}
        for splits in range(1, _gemv.DECODE_MAX_SPLITS + 1):
            if math.ceil(k_steps / math.ceil(k_steps / splits)) != splits:
                continue
            gk.decode_splits = lambda *_, _s=splits: _s
            ms[splits] = c.timed_ms(
                lambda p: gk.bitplane_gemv_cuda(p, scale, x, bits=bits,
                                                radix=1, out_dtype=dt),
                packs, torch)
        gk.decode_splits = picked
        print(json.dumps(dict(m=m, k=k, n=n, bits=bits, dtype=str(dt),
                              ms_by_splits=ms,
                              picked=picked(k, n, _gemv.sm_count(dev)))),
              flush=True)
        del packs
    return 0


if __name__ == "__main__":
    sys.exit(main())
