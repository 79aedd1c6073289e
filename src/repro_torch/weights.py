"""Conversion of a JAX-side parameter tree, as numpy arrays, into the port's
parameters.

The JAX package stacks layers on axis 0 (its ``init_params`` vmaps over
layers); the port keeps one dictionary per layer, so every leaf under
``"layers"`` is unstacked here.  An engine-packed linear arrives as a dict
``{"packed", "scale", "bias", "bits"}`` and becomes a
:class:`~repro_torch.engine.PackedLinear` whose bytes are the JAX bytes.
The ssm family's per-head parameters (``a_log``, ``dt_bias``, ``d_skip``)
are float32 in every model dtype, as the JAX package keeps them.
:func:`stack_layers` / :func:`unstack_layers` move the port's own
parameters between the two layouts.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.packed import PackedLinear, validate_bits
from repro_torch.tree import tree_leaves, tree_map

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
        kp, n = packed.shape[-2:]
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


def stack_layers(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters in the JAX package's layout: ``"layers"``
    one tree whose every leaf stacks the layers' leaves on axis 0 (a new
    tensor; the other entries are shared).  The training loop keeps its
    params, optimizer state and checkpoints in this layout, so the
    optimizer sees the leaves JAX's sees."""
    layers = params["layers"]
    out = dict(params)
    out["layers"] = tree_map(lambda *leaves: torch.stack(leaves), layers[0],
                             *layers[1:])
    return out


def unstack_layers(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`stack_layers`: one dictionary per layer, whose
    leaves are views of the stacked leaves (no copy)."""
    stacked = params["layers"]
    n = tree_leaves(stacked)[0].shape[0]
    out = dict(params)
    out["layers"] = [tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]
    return out
