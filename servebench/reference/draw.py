"""The benchmark's inputs of a model: its weights, drawn from the seed.

Both sides take the same draws: the harness hands each layer to the
program, which packs it; the plain reference draws the layer again and
quantises it with its own arithmetic.  A layer's weights come from one
generator seeded by ``(seed, layer)`` on the device, in a fixed order of
calls, so two draws of one layer on one device are equal bit for bit.

Distributions: linears ``N(0, 1/d_in)``, the embedding ``N(0, 0.02^2)``,
norm scales ``N(0, 0.1^2)`` (the model applies ``1 + scale``), all drawn
in float32 and rounded to the model's dtype.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

EMBED = -1   # the "layer" index of the embedding's generator
HEAD = -2    # the final norm's and the head's


def generator(seed: int, layer: int, device) -> torch.Generator:
    """The generator of ``layer`` (or ``EMBED`` / ``HEAD``) under ``seed``."""
    digest = hashlib.sha256(f"servebench:{int(seed)}:{int(layer)}".encode())
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest.digest()[:8], "little") >> 1)
    return gen


def _normal(gen, shape, std, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(std).to(dtype)


def _linear(gen, d_in, d_out, dtype) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), d_in ** -0.5, dtype)


def draw_layer(model: Dict, seed: int, layer: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One decoder layer as flat named tensors, ``(K, N)`` for a linear:
    ``ln1``, ``wq``, ``wk``, ``wv``, ``wo``, ``ln2``, ``w_up``,
    (``w_gate``,) ``w_down``.  ``model``: the configuration's sizes."""
    gen = generator(seed, layer, device)
    d, dh = model["d_model"], model["head_dim"]
    hq, hkv, f = model["n_heads"], model["n_kv_heads"], model["d_ff"]
    out = {"ln1": _normal(gen, (d,), 0.1, dtype),
           "wq": _linear(gen, d, hq * dh, dtype),
           "wk": _linear(gen, d, hkv * dh, dtype),
           "wv": _linear(gen, d, hkv * dh, dtype),
           "wo": _linear(gen, hq * dh, d, dtype),
           "ln2": _normal(gen, (d,), 0.1, dtype),
           "w_up": _linear(gen, d, f, dtype)}
    if model["mlp_gated"]:
        out["w_gate"] = _linear(gen, d, f, dtype)
    out["w_down"] = _linear(gen, f, d, dtype)
    return out


def draw_embed(model: Dict, seed: int, device,
               dtype=torch.bfloat16) -> torch.Tensor:
    """The ``(V, D)`` embedding table."""
    gen = generator(seed, EMBED, device)
    return _normal(gen, (model["vocab_size"], model["d_model"]), 0.02, dtype)


def draw_head(model: Dict, seed: int, device,
              dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The final norm's scale and the untied ``(D, V)`` head."""
    gen = generator(seed, HEAD, device)
    d = model["d_model"]
    return {"final_norm": _normal(gen, (d,), 0.1, dtype),
            "lm_head": _linear(gen, d, model["vocab_size"], dtype)}
