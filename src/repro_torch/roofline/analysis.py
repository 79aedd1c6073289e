"""Three-term roofline of a counted cell: the port's counterpart of the
JAX package's ``repro/roofline/analysis.py``.

  compute    = FLOPs_per_rank / peak_FLOP/s
  memory     = bytes_per_rank / HBM_bw
  collective = collective_bytes_per_rank / link_bw

The counts come from :func:`counted_costs` (``roofline.op_cost``: the cell
run once, eagerly, under the op counter; on ``meta`` for a dry run, a
rank's shapes and no memory).  :func:`collective_bytes` reads the
collectives' tally by JAX's family names, the counterpart of
``collective_bytes_from_hlo``.

Hardware constants: the NVIDIA H100 SXM data sheet (700 W): dense bf16
989 TFLOP/s, 3.35 TB/s HBM3, 450 GB/s NVLink each way.  The port carries
no TPU constant; a caller may pass another ``hw``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# the counterpart of JAX's ``compiled_costs``: every eager op runs, so no
# loop is undercounted (``OpCounter.result``'s keys, and ``count_s``)
from repro_torch.roofline.op_cost import COLLECTIVES, counted_costs

HW_H100 = {
    "peak_flops": 989e12,   # dense bf16 FLOP/s (data sheet, SXM)
    "hbm_bw": 3.35e12,      # bytes/s HBM3 (data sheet)
    "link_bw": 450e9,       # bytes/s NVLink, each way (data sheet)
}


__all__ = ["HW_H100", "collective_bytes", "counted_costs",
           "model_bytes_for_cell", "model_flops_for_cell", "roofline_report"]


def collective_bytes(counted: Dict[str, Any]) -> Dict[str, float]:
    """Per-rank bytes of each collective family of a count, and
    ``total``."""
    coll = counted.get("collectives", {})
    out = {c: float(coll.get(c, 0.0)) for c in COLLECTIVES}
    out["total"] = sum(out[c] for c in COLLECTIVES)
    return out


def roofline_report(
    counted: Dict[str, Any],
    n_devices: int,
    *,
    model_flops: Optional[float] = None,
    model_bytes: Optional[float] = None,
    hw: Dict[str, float] = HW_H100,
) -> Dict[str, Any]:
    """The roofline record of one counted cell, JAX's keys and arithmetic:
    the three terms, ``dominant``, ``bound_seconds``, the memory figures,
    and with ``model_flops`` the ``useful_flops_ratio`` and the
    ``roofline_fraction`` (an ideal implementation's time, the larger of
    the model's FLOPs at peak and its minimal bytes at HBM rate, over
    ``bound_seconds``)."""
    flops_dev = float(counted["flops"])
    bytes_dev = float(counted["bytes"])
    coll = collective_bytes(counted)

    t_compute = flops_dev / hw["peak_flops"]
    t_memory = bytes_dev / hw["hbm_bw"]
    t_coll = coll["total"] / hw["link_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)

    report = {
        "n_devices": n_devices,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll,
        "regions": counted.get("regions", {}),
        **terms,
        "dominant": dominant,
        "bound_seconds": max(terms.values()),
        "memory_analysis": dict(counted.get("memory_analysis", {})),
    }
    if model_flops is not None:
        report["model_flops_total"] = model_flops
        total = flops_dev * n_devices
        report["useful_flops_ratio"] = model_flops / total if total else 0.0
        ideal_c = model_flops / (n_devices * hw["peak_flops"])
        ideal_m = (model_bytes or 0.0) / (n_devices * hw["hbm_bw"])
        ideal = max(ideal_c, ideal_m)
        bound = max(terms.values())
        report["ideal_compute_s"] = ideal_c
        report["ideal_memory_s"] = ideal_m
        report["roofline_fraction"] = ideal / bound if bound else 0.0
    return report


def model_flops_for_cell(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training (N = params, D = tokens), 2·N_active·D
    for inference steps."""
    n = cfg.param_count()
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def model_bytes_for_cell(cfg, shape, weight_bits: int = 0,
                         cache_bytes: float = 0.0) -> float:
    """Minimal global HBM bytes an ideal implementation must move.

    decode : active weights once per step (b/8 bytes each with the IMAGine
             engine, else 2 bf16) + one read of the KV/state cache
    prefill: weights once + one cache write + one activation pass
    train  : params fwd+bwd reads, grad write, AdamW m/v read+write
             (≈ 26 bytes/param with bf16 params + fp32 moments)
    """
    wb = (weight_bits / 8.0) if weight_bits else 2.0
    n_active = cfg.active_param_count()
    if shape.kind == "decode":
        return n_active * wb + cache_bytes
    if shape.kind == "prefill":
        act = 2.0 * shape.global_batch * shape.seq_len * cfg.d_model * cfg.n_layers
        return n_active * wb + cache_bytes + act
    return cfg.param_count() * 26.0
