"""Conversion of a JAX-side parameter tree, as numpy arrays, into the port's
parameters.

The JAX package stacks layers on axis 0 (its ``init_params`` vmaps over
layers); the port keeps one dictionary per layer, so every leaf under
``"layers"`` is unstacked here.  An engine-packed linear arrives as a dict
``{"packed", "scale", "bias", "bits"}`` and becomes a
:class:`~repro_torch.engine.PackedLinear` whose bytes are the JAX bytes.
The ssm family's per-head parameters (``a_log``, ``dt_bias``, ``d_skip``)
are float32 in every model dtype, as the JAX package keeps them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.packed import PackedLinear, validate_bits

_FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip")


def _tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: widen exactly first
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _convert(node: Any, layer: Optional[int], device, dtype) -> Any:
    def pick(a):
        return np.asarray(a)[layer] if layer is not None else a

    if isinstance(node, dict) and "packed" in node:
        bits = validate_bits(node["bits"])
        packed = _tensor(pick(node["packed"]), device, None)
        scale = _tensor(pick(node["scale"]), device, torch.float32)
        bias = node.get("bias")
        if bias is not None:
            bias = _tensor(pick(bias), device, dtype)
        kp, n = packed.shape
        return PackedLinear(packed, scale, bias, bits, kp * (8 // bits), n)
    if isinstance(node, dict):
        return {k: _convert(v, layer, device,
                            torch.float32 if k in _FLOAT32_LEAVES else dtype)
                for k, v in node.items()}
    return _tensor(pick(node), device, dtype)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX parameter tree (numpy leaves, packed linears as dicts) as the
    port's parameters on ``device`` (None means the GPU).  ``dtype`` casts
    the float leaves except the per-channel scales and the ssm per-head
    parameters, which stay float32."""
    device = resolve_device(device)
    out = {k: _convert(v, None, device, dtype)
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [_convert(tree["layers"], i, device, dtype)
                     for i in range(cfg.n_layers)]
    return out
