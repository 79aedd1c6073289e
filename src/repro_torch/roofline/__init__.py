"""Roofline of a cell: the op counter that prices an eager program
(``op_cost``, the counterpart of the JAX package's ``hlo_cost``), the
kernels' own bytes and operations (``kernel_costs``), and the three-term
report (``analysis``)."""

from repro_torch.roofline.analysis import (
    HW_H100,
    collective_bytes,
    counted_costs,
    model_bytes_for_cell,
    model_flops_for_cell,
    roofline_report,
)

__all__ = ["HW_H100", "collective_bytes", "counted_costs",
           "model_bytes_for_cell", "model_flops_for_cell", "roofline_report"]
