"""Executable model of the IMAGine GEMV tile (paper Fig. 2b / Fig. 3).

This is a *block-level, cycle-counted* functional simulator:

  * the PE array state is held as numpy arrays (each PE = one bit-serial
    column of a PiCaSO-IM block; the simulator applies whole-array SIMD
    semantics, which is exactly what the broadcast fanout tree does);
  * the controller FSM walks an :mod:`repro_torch.core.isa` program,
    dispatching each instruction to the single-cycle or the multicycle
    driver and charging cycles from :class:`CycleModel` — the same model
    ``latency_model`` uses analytically, so the two are cross-validated in
    tests;
  * results are exact integer GEMV values, compared bit-for-bit against
    ``W @ x`` and against the card's kernels.

The cycle constants model a radix-2 bit-serial PE with read-modify-write
BRAM access (4 cycles per bit-op during multiply, 2 per bit during adds),
calibrated so the engine's implied peak throughput on the U55 (64K PEs @
737 MHz) reproduces the paper's "up to 0.33 TOPS at 8-bit" within a few
per-cent.  Radix 2 retires two multiplier bits per pass (the paper's
"slice4" / Booth radix-4 variant).

It models the FPGA, so it stays a host-side numpy simulator: run as tensors
on the card it would launch one tiny kernel per instruction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.isa import (
    Instr,
    MAX_ELEMS,
    Op,
    REG_ACC,
    REG_TMP,
    REG_W_BASE,
    REG_X_BASE,
    SINGLE_CYCLE,
    assemble_gemv,
)


@dataclass(frozen=True)
class CycleModel:
    """Cycle cost of each multicycle operation (radix-2 defaults).

    ``radix_bits``: multiplier bits retired per pass (1 = radix-2 bit-serial,
    2 = radix-4 Booth = the paper's "slice4" variant).
    """

    precision: int = 8          # operand bit width p
    acc_width: int = 24         # accumulator width (2p + headroom)
    radix_bits: int = 1
    rmw_mult: int = 4           # BRAM read-modify-write cycles per mult bit-op
    rmw_add: int = 2            # cycles per bit during add/sub/mov
    issue: int = 2              # multicycle driver: param load + dispatch

    def mult(self) -> int:
        p = self.precision
        passes = (p + self.radix_bits - 1) // self.radix_bits
        return self.rmw_mult * passes * p + self.issue

    def add(self, width: Optional[int] = None) -> int:
        w = width or self.acc_width
        return self.rmw_add * w + self.issue

    def mac(self) -> int:
        # multiply + accumulate into [ptr]; data movement overlapped via the
        # third (pointer) address, so only the 2p-bit product add is exposed
        # (the carry into the high accumulator bits is overlapped with the
        # next multiply's first pass).
        return self.mult() + self.add(2 * self.precision)

    def mov(self) -> int:
        return self.rmw_add * self.precision + self.issue

    def accum(self, n_cols: int) -> int:
        # pipelined east->west systolic sweep: one hop per column plus the
        # bit-serial drain of the accumulator word.
        return (n_cols - 1) + self.rmw_add * self.acc_width + self.issue

    def single(self) -> int:
        return 1

    def for_instr(self, instr: Instr, n_cols: int) -> int:
        if instr.op in SINGLE_CYCLE:
            return self.single()
        if instr.op == Op.MULT:
            return self.mult()
        if instr.op == Op.MAC:
            return self.mac()
        if instr.op in (Op.ADD, Op.SUB):
            return self.add()
        if instr.op == Op.MOV:
            return self.mov()
        if instr.op == Op.ACCUM:
            return self.accum(n_cols)
        raise ValueError(f"no timing for {instr.op}")


@dataclass
class TileState:
    """PE-array architectural state: (rows, cols) PEs x 64-word regfile."""

    rows: int
    cols: int
    regs: np.ndarray = field(init=False)      # (rows, cols, 64) int64
    ptr: int = 0
    shift_out: List[np.ndarray] = field(default_factory=list)

    def __post_init__(self):
        self.regs = np.zeros((self.rows, self.cols, 64), dtype=np.int64)


class GemvTileController:
    """FSM model: 2-state driver selection + single/multicycle drivers."""

    def __init__(self, rows: int, cols: int, model: Optional[CycleModel] = None):
        self.state = TileState(rows, cols)
        self.model = model or CycleModel()
        self.cycles = 0
        self.instr_count: Dict[Op, int] = {}
        self.halted = False

    # -- host-side data load (through the input registers / fanout tree) ----
    def load_weights(self, w_elems: np.ndarray) -> None:
        """w_elems: (rows, cols, n_elems) integer weight slices."""
        n = w_elems.shape[-1]
        if n > MAX_ELEMS:
            raise ValueError(f"{n} elements exceed PE capacity")
        self.state.regs[:, :, REG_W_BASE : REG_W_BASE + n] = w_elems
        # one LOADV per element row, broadcast by the fanout tree
        self.cycles += n

    def load_activations(self, x_elems: np.ndarray) -> None:
        """x_elems: (cols, n_elems), broadcast down each PE column."""
        n = x_elems.shape[-1]
        self.state.regs[:, :, REG_X_BASE : REG_X_BASE + n] = x_elems[None]
        self.cycles += n

    # -- execution -----------------------------------------------------------
    def execute(self, program: List[Instr]) -> None:
        for instr in program:
            if self.halted:
                raise RuntimeError("execute after HALT")
            self._dispatch(instr)
            self.cycles += self.model.for_instr(instr, self.state.cols)
            self.instr_count[instr.op] = self.instr_count.get(instr.op, 0) + 1

    def _dispatch(self, instr: Instr) -> None:
        regs, ptr = self.state.regs, self.state.ptr
        op = instr.op
        if op == Op.NOP:
            pass
        elif op == Op.SETPTR:
            self.state.ptr = instr.imm
        elif op == Op.LOADV:
            pass  # data path modeled by load_weights/load_activations
        elif op == Op.MOV:
            regs[:, :, instr.rd] = regs[:, :, instr.rs1]
        elif op == Op.ADD:
            regs[:, :, instr.rd] = regs[:, :, instr.rs1] + regs[:, :, instr.rs2]
        elif op == Op.SUB:
            regs[:, :, instr.rd] = regs[:, :, instr.rs1] - regs[:, :, instr.rs2]
        elif op == Op.MULT:
            regs[:, :, instr.rd] = regs[:, :, instr.rs1] * regs[:, :, instr.rs2]
        elif op == Op.MAC:
            regs[:, :, ptr] = regs[:, :, ptr] + (
                regs[:, :, instr.rs1] * regs[:, :, instr.rs2]
            )
        elif op == Op.ACCUM:
            # east->west: partials accumulate into the west-most PE column
            total = regs[:, :, instr.rd].sum(axis=1)
            regs[:, :, instr.rd] = 0
            regs[:, 0, instr.rd] = total
        elif op == Op.SHIFT:
            # column shift register: emit the current west-column word of the
            # oldest pending fold result (modeled as FIFO append).
            self.state.shift_out.append(regs[:, 0, REG_ACC].copy())
        elif op == Op.HALT:
            self.halted = True
        else:
            raise ValueError(f"unknown op {op}")


def run_gemv(
    w: np.ndarray,
    x: np.ndarray,
    rows: int = 16,
    cols: int = 8,
    model: Optional[CycleModel] = None,
) -> "GemvResult":
    """Run an exact integer GEMV ``y = w @ x`` on the tile model.

    ``w``: (M, K) integers, ``x``: (K,) integers.  The matrix is folded over
    the PE grid: matrix row ``i`` lives on PE row ``i % rows`` of fold
    ``i // rows``; row elements are split contiguously across PE columns.
    """
    m, k = w.shape
    ctrl = GemvTileController(rows, cols, model)
    elems = -(-k // cols)  # per-PE slice length
    if elems > MAX_ELEMS:
        raise ValueError(
            f"K={k} over {cols} columns needs {elems} elems/PE > {MAX_ELEMS}"
        )
    folds = -(-m // rows)
    xp = np.zeros((cols, elems), dtype=np.int64)
    for c in range(cols):
        seg = x[c * elems : (c + 1) * elems]
        xp[c, : len(seg)] = seg
    ctrl.load_activations(xp)

    y = np.zeros(m, dtype=np.int64)
    total_instrs = 0
    for f in range(folds):
        wp = np.zeros((rows, cols, elems), dtype=np.int64)
        for r in range(rows):
            i = f * rows + r
            if i >= m:
                break
            for c in range(cols):
                seg = w[i, c * elems : (c + 1) * elems]
                wp[r, c, : len(seg)] = seg
        ctrl.load_weights(wp)
        prog = assemble_gemv(elems, 1, rows)
        ctrl.execute(prog[:-1])  # defer HALT until all folds are done
        total_instrs += len(prog) - 1
        out = np.stack(ctrl.state.shift_out, axis=0)  # (rows, rows) shifts
        ctrl.state.shift_out.clear()
        take = min(rows, m - f * rows)
        y[f * rows : f * rows + take] = out[-1][:take]
    ctrl.execute([Instr(Op.HALT)])
    return GemvResult(y=y, cycles=ctrl.cycles, instrs=total_instrs + 1, ctrl=ctrl)


@dataclass
class GemvResult:
    y: np.ndarray
    cycles: int
    instrs: int
    ctrl: GemvTileController
