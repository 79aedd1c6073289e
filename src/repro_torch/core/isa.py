"""IMAGine's 30-bit instruction set (paper §IV-C, Fig. 3a).

The paper specifies a 30-bit instruction executed by a 2-driver tile
controller (single-cycle + multicycle) but does not publish the bit-level
encoding; the encoding below is our documented model, chosen to fit the
described fields: an opcode, up to two BRAM word addresses (PiCaSO-F exposes
two simultaneous addresses), and an immediate.  The *third* address required
by the accumulation algorithm lives in the pointer register (``SETPTR``),
exactly as §IV-D describes ("we added a pointer register for the third
address").

Layout (30 bits):  ``[opcode:5 | rd:6 | rs1:6 | rs2:6 | imm:7]``

Word addresses index a 64-entry logical register file per PE (one BRAM
column sliced into 16-bit words).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import List, Tuple

INSTR_BITS = 30
_OPC_BITS, _RD_BITS, _RS_BITS, _IMM_BITS = 5, 6, 6, 7


class Op(IntEnum):
    NOP = 0
    SETPTR = 1   # pointer register <- imm          (single-cycle)
    LOADV = 2    # host writes a vector word        (single-cycle per word)
    MOV = 3      # rd <- rs1                        (multicycle: p bits)
    ADD = 4      # rd <- rs1 + rs2                  (multicycle)
    SUB = 5      # rd <- rs1 - rs2                  (multicycle)
    MULT = 6     # rd <- rs1 * rs2  (bit-serial)    (multicycle)
    MAC = 7      # [ptr] <- [ptr] + rs1 * rs2       (multicycle, 3rd addr via ptr)
    ACCUM = 8    # east->west array accumulation    (multicycle)
    SHIFT = 9    # shift result column up one slot  (single-cycle)
    HALT = 31


SINGLE_CYCLE = {Op.NOP, Op.SETPTR, Op.LOADV, Op.SHIFT, Op.HALT}


@dataclass(frozen=True)
class Instr:
    op: Op
    rd: int = 0
    rs1: int = 0
    rs2: int = 0
    imm: int = 0

    def encode(self) -> int:
        for name, val, bits in (
            ("rd", self.rd, _RD_BITS),
            ("rs1", self.rs1, _RS_BITS),
            ("rs2", self.rs2, _RS_BITS),
            ("imm", self.imm, _IMM_BITS),
        ):
            if not 0 <= val < (1 << bits):
                raise ValueError(f"{name}={val} out of range for {bits} bits")
        word = (
            (int(self.op) << (INSTR_BITS - _OPC_BITS))
            | (self.rd << (_RS_BITS * 2 + _IMM_BITS))
            | (self.rs1 << (_RS_BITS + _IMM_BITS))
            | (self.rs2 << _IMM_BITS)
            | self.imm
        )
        assert word < (1 << INSTR_BITS)
        return word


def decode(word: int) -> Instr:
    if not 0 <= word < (1 << INSTR_BITS):
        raise ValueError(f"not a {INSTR_BITS}-bit word: {word}")
    op = Op((word >> (INSTR_BITS - _OPC_BITS)) & ((1 << _OPC_BITS) - 1))
    rd = (word >> (_RS_BITS * 2 + _IMM_BITS)) & ((1 << _RD_BITS) - 1)
    rs1 = (word >> (_RS_BITS + _IMM_BITS)) & ((1 << _RS_BITS) - 1)
    rs2 = (word >> _IMM_BITS) & ((1 << _RS_BITS) - 1)
    imm = word & ((1 << _IMM_BITS) - 1)
    return Instr(op, rd, rs1, rs2, imm)


# ---------------------------------------------------------------------------
# Register-file convention used by the GEMV program
# ---------------------------------------------------------------------------
# word 0            : accumulator (2p + log2(K) bits wide logically)
# word 1            : multiply scratch
# words 2..2+E      : weight elements (this PE's slice of a matrix row)
# words 34..34+E    : activation elements (broadcast down the PE column)
REG_ACC = 0
REG_TMP = 1
REG_W_BASE = 2
REG_X_BASE = 34
MAX_ELEMS = 30  # per-PE element capacity with this register map


def assemble_gemv(n_elems: int, n_folds: int, out_rows: int) -> List[Instr]:
    """Emit the instruction stream for one tiled GEMV.

    Per fold: clear the accumulator, MAC across the PE's ``n_elems``
    elements (bit-serial multiply-accumulate, third address = accumulator
    via the pointer register), then an east->west ACCUM sweep; finally the
    result column is shifted out one element per cycle.
    """
    if n_elems > MAX_ELEMS:
        raise ValueError(f"n_elems={n_elems} exceeds PE capacity {MAX_ELEMS}")
    prog: List[Instr] = []
    for _ in range(n_folds):
        prog.append(Instr(Op.SETPTR, imm=REG_ACC))
        prog.append(Instr(Op.SUB, rd=REG_ACC, rs1=REG_ACC, rs2=REG_ACC))  # acc = 0
        for e in range(n_elems):
            prog.append(Instr(Op.MAC, rs1=REG_W_BASE + e, rs2=REG_X_BASE + e))
        prog.append(Instr(Op.ACCUM, rd=REG_ACC))
    for _ in range(out_rows):
        prog.append(Instr(Op.SHIFT))
    prog.append(Instr(Op.HALT))
    return prog


def roundtrip(prog: List[Instr]) -> Tuple[List[int], List[Instr]]:
    words = [i.encode() for i in prog]
    return words, [decode(w) for w in words]
