"""The paper, end to end, on one GEMV, with the engine on the card.

1. Assemble the 30-bit ISA program for a tiled integer GEMV (paper Fig. 2/3).
2. Execute it on the cycle-counted tile-controller model: an exact result.
3. Run the same GEMV through the engine on the card: the bit-plane kernel
   (``core.gemv_engine.gemv``) and the int8 bit-parallel baseline
   (``kernels.int8_matvec``).  Both take the weights quantized to 8 bits
   with one scale per output channel, so they agree with the exact result
   to a few 1e-3: the error is the quantization's, not the kernels'.
4. Report the paper's figures of merit: cycles, execution time at 737 MHz,
   and the latency-model comparison against CCB / CoMeFa / SPAR-2 / BRAMAC
   (paper Fig. 6).

    PYTHONPATH=src python -m repro_torch.paper_demo [--dim 96] [--device cpu]

With no ``--device`` it runs on the GPU, and raises on a host without one.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.controller import run_gemv
from repro_torch.core.gemv_engine import gemv, quantize_linear
from repro_torch.core.isa import MAX_ELEMS, assemble_gemv, roundtrip
from repro_torch.core.latency_model import FIG6_DESIGNS, IMAGINE_FSYS_MHZ
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.backends import resolve_backend_name
from repro_torch.kernels.int8_matvec import int8_matvec

# dim * 127 * 127 < 2^24: every partial sum of the engine's products of
# 8-bit codes and 8-bit activations is exact in float32
MAX_DIM = 1040


def run(dim: int = 96, *, device: DeviceLike = None) -> Dict[str, object]:
    """Steps 1-4 on a seeded ``dim x dim`` integer GEMV; raises if the ISA
    program does not round-trip, the tile model is not exact, or an engine
    result lies beyond the 8-bit quantization bound."""
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"dim must lie in [1, {MAX_DIM}], got {dim}")
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    w = rng.integers(-127, 128, size=(dim, dim))
    x = rng.integers(-127, 128, size=(dim,))
    want = w @ x

    prog = assemble_gemv(n_elems=12, n_folds=1, out_rows=16)
    words, decoded = roundtrip(prog)
    if decoded != prog:
        raise AssertionError("the ISA program does not round-trip")

    res = run_gemv(w, x, rows=16, cols=max(8, -(-dim // MAX_ELEMS)))
    if not np.array_equal(res.y, want):
        raise AssertionError("the FPGA model must be exact")

    # integer weights, quantized as the engine stores them
    ql = quantize_linear(torch.as_tensor(w.T, dtype=torch.float32,
                                         device=device), bits=8)
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    y_bitplane = gemv(ql, xt)
    y_int8 = int8_matvec(ql.packed, ql.scale, xt)
    # Every product and partial sum of integer codes and activations is
    # exact in float32 (MAX_DIM), so each output differs from w @ x by the
    # quantization (at most sum|x| * scale / 2) and one rounding of the
    # scaled sum.
    scale = ql.scale.cpu().numpy()[0].astype(np.float64)
    bound = np.abs(x).sum() * scale / 2 + 2.0 ** -23 * np.abs(want)
    denom = max(1.0, float(np.max(np.abs(want))))

    def rel_err(name: str, y: torch.Tensor) -> float:
        err = np.abs(y.cpu().numpy().astype(np.float64) - want)
        if not bool((err <= bound).all()):
            raise AssertionError(f"{name}: error {float(err.max())} beyond "
                                 "the 8-bit quantization bound")
        return float(err.max()) / denom

    fig6: List[Dict[str, Optional[float]]] = []
    for name, (fn, f_mhz) in FIG6_DESIGNS.items():
        cycles = fn(dim, 8)
        fig6.append(dict(design=name, cycles=cycles,
                         exec_us=cycles / f_mhz if f_mhz else None))
    return dict(
        dim=dim, device=str(device),
        backend=resolve_backend_name("auto", device),
        instructions=len(prog), words=words, exact=True,
        cycles=res.cycles, instrs=res.instrs,
        exec_us=res.cycles / IMAGINE_FSYS_MHZ, y=res.y,
        rel_err_bitplane=rel_err("bit-plane GEMV", y_bitplane),
        rel_err_int8=rel_err("int8_matvec", y_int8),
        fig6=fig6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=96)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    r = run(args.dim, device=args.device)

    print("== 1. assemble the ISA program ==")
    print(f"instructions={r['instructions']} first 4 encoded: "
          + " ".join(f"{wd:08x}" for wd in r["words"][:4]))
    print("== 2. execute on the tile-controller model ==")
    print(f"exact={r['exact']} cycles={r['cycles']} "
          f"exec={r['exec_us']:.2f}us @737MHz  y[:4]={r['y'][:4]}")
    print(f"== 3. the same GEMV on the engine ({r['device']}) ==")
    print(f"bit-plane GEMV ({r['backend']}): "
          f"rel_err={r['rel_err_bitplane']:.2e}")
    print(f"int8 bit-parallel baseline: rel_err={r['rel_err_int8']:.2e}")
    print("== 4. latency-model comparison (paper Fig. 6) ==")
    for row in r["fig6"]:
        t = (f"{row['exec_us']:8.1f}us" if row["exec_us"] is not None
             else "   (n/a)")
        print(f"  {row['design']:16s} cycles={row['cycles']:>8d} exec={t}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
