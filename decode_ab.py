#!/usr/bin/env python3
"""Time the decode step's kernels, the int8 baseline's decode route and the
SSD scan of two checkouts on one GPU, in turns.

Run from anywhere, with the roots of two checkouts (for instance this one
and an earlier commit unpacked with ``git archive`` under ``build/``)::

    python3 decode_ab.py TREE_A TREE_B [--rounds 2]

Each round runs tree A, then tree B, each in its own process from its own
root: the process imports that tree's ``chip_smoke.py`` (so each tree's
kernels are built from its own sources into its own ``build/kernels``) and
times, with that script's ``attn_time``, ``gemv_time``, ``int8_time`` and
``ssd_time`` (CUDA events over launches that rotate inputs beyond L2), the
decode step's kernels at the
main paths' shapes: paged decode attention over int8 and bf16 pools; the
bit-plane GEMV's decode route at M = 8 for qwen2.5-3b's four linears at 4,
8 (radix 1 and 2) and 2 bits, at M = 2 (``long``'s decode steps) and M = 4
(``ssm``'s, mamba2-130m's linears), and at M = 1 in float32 at d = 2048
and 1983 (the ``engine`` phase's GEMVs); the int8 bit-parallel baseline
at M = 1 and 8 (bf16) on the same four linears and at M = 1 in float32 at
d = 2048 and 1983 (its decode route); and the SSD scan at the ``ssm``
shape (``ssd_time``).  So A, B, A, B, ... share one card and its power
limit.  It prints the card's name and power limit, one JSON
line per timed row (``tree``, ``round`` and the row as ``chip_smoke.py``
emits it), and a summary line: each row's ``ms`` per tree and round.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# runs in each tree's root; prints the tree's "time" lines
CHILD = r"""
import sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke as c
from repro_torch.kernels import _build

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
_build.build()
for kind in ("int8", "bfloat16"):
    c.attn_time(torch, dev, kind, "decode")
for bits, radix in ((4, 1), (8, 1), (8, 2), (2, 1)):
    for k, n in c.GEMV_SHAPES:
        c.gemv_time(torch, dev, 8, k, n, bits=bits, radix=radix)
for k, n in c.GEMV_SHAPES:
    c.gemv_time(torch, dev, 2, k, n)
for k, n in c.SSM_GEMV_SHAPES:
    c.gemv_time(torch, dev, 4, k, n)
for d in (2048, 1983):
    for radix in (1, 2):
        c.gemv_time(torch, dev, 1, d, d, bits=8, radix=radix,
                    dt=torch.float32)
for m in (1, 8):
    for k, n in c.GEMV_SHAPES:
        c.int8_time(torch, dev, m, k, n)
for d in (2048, 1983):
    c.int8_time(torch, dev, 1, d, d, dt=torch.float32)
c.ssd_time(torch, dev)
"""


def row_key(rec: dict) -> str:
    if rec["kernel"] == "bitplane_gemv":
        return (f"bitplane_gemv m={rec['m']} k={rec['k']} n={rec['n']} "
                f"bits={rec['bits']} radix={rec['radix']} {rec['dtype']}")
    if rec["kernel"] == "int8_matvec":
        return (f"int8_matvec m={rec['m']} k={rec['k']} n={rec['n']} "
                f"{rec['dtype']}")
    if rec["kernel"] == "ssd_scan":
        return (f"ssd_scan b={rec['b']} s={rec['s']} h={rec['h']} "
                f"n={rec['n']} chunk={rec['chunk']}")
    return f"{rec['kernel']} pools={rec['pools']}"


def run_tree(tree: Path, timeout: int):
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: exit {out.returncode}\n"
                           f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    rows = []
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("phase") == "time":
                rows.append(rec)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs=2, type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=900)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    summary: dict = {}
    for rnd in range(args.rounds):
        for label, tree in zip("AB", args.trees):
            for rec in run_tree(tree.resolve(), args.timeout):
                print(json.dumps({"tree": label, "round": rnd, **rec}),
                      flush=True)
                summary.setdefault(row_key(rec), {}).setdefault(
                    label, []).append(rec["ms"])
    print(json.dumps({"trees": {label: str(tree) for label, tree in
                                zip("AB", args.trees)},
                      "card": smi, "ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
