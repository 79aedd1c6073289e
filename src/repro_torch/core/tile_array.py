"""GEMV tile-array geometry (paper Fig. 2, Table III/IV).

Hierarchy on the FPGA:
  device = grid of GEMV tiles;  tile = 12 x 2 PIM blocks (+controller+fanout);
  PIM block = one BRAM18 = 16 bit-serial PEs  =>  32 PEs per BRAM36,
  12 BRAM36 per tile => 384 PEs per tile.
U55: 2016 BRAM36 -> 168 tiles -> 64512 PEs ("64K", Table IV).

On the card the engine's kernels tile by their own grid (column blocks of
the packed weight, K split across the warps of a block); this geometry
sizes the FPGA model, not the kernels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.latency_model import Device, PE_PER_BRAM, TABLE_IV, U55

BRAMS_PER_TILE = 12       # Table III: one GEMV tile consumes 12 BRAM36
BLOCK_GRID = (12, 2)      # PIM blocks per tile (Fig. 2b)
PES_PER_BLOCK = 16        # one BRAM18 column group
PES_PER_TILE = BRAMS_PER_TILE * PE_PER_BRAM  # 384
PE_REGFILE_BITS = 1024    # usable bit-column depth per PE


@dataclass(frozen=True)
class TileArrayGeometry:
    device: Device

    @property
    def n_tiles(self) -> int:
        return self.device.brams // BRAMS_PER_TILE

    @property
    def n_pes(self) -> int:
        return self.n_tiles * PES_PER_TILE

    @property
    def pe_rows(self) -> int:
        # tiles stack vertically (column shift-register readout), PE rows
        # per tile = block-grid rows.
        return BLOCK_GRID[0] * max(1, int(math.sqrt(self.n_tiles)))

    @property
    def pe_cols(self) -> int:
        return self.n_pes // self.pe_rows

    def max_square_gemv(self, bits: int = 8) -> int:
        """Largest D for a D x D GEMV with weights resident (100% BRAM-as-PIM).

        Each PE stores its slice of weights + activations + workspace in a
        PE_REGFILE_BITS bit column.
        """
        workspace = 2 * (2 * bits + 8)
        elems_per_pe = (PE_REGFILE_BITS - workspace) // (2 * bits)
        capacity = self.n_pes * elems_per_pe
        return int(math.floor(math.sqrt(capacity)))

    def occupancy(self, m: int, k: int, bits: int = 8) -> float:
        """Fraction of PE weight capacity used by an m x k matrix."""
        workspace = 2 * (2 * bits + 8)
        elems_per_pe = (PE_REGFILE_BITS - workspace) // (2 * bits)
        return min(1.0, (m * k) / (self.n_pes * elems_per_pe))


def u55_geometry() -> TileArrayGeometry:
    return TileArrayGeometry(U55)


def all_geometries():
    return {d.short_id: TileArrayGeometry(d) for d in TABLE_IV}
