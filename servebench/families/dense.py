"""The dense family: a decoder of grouped-query attention and a SwiGLU or
tanh-GELU MLP (``reference/model.py`` states it): the configurations whose
model's ``family`` is ``dense``.

A family module gives the harness four functions, found by the
configuration's family (``families/<family>.py``):

- ``build_params(cfg, model, bits, seed, device)``: the port's params
  tree, each layer drawn from ``(seed, layer)`` and packed by the port's
  ``quantize_params`` as it is drawn;
- ``score(model, engine, seed, sequences, positions, device, act_format,
  extra, keep)``: the plain reference that ``check.py`` reads, the
  control (``act_format="fp8"``) included;
- ``token_flops(model, position)``: the model FLOPs of one token
  (``metrics/mfu.py``);
- ``decode_step_bytes(model, engine, lanes, contexts, step)``: the bytes
  one decode step must move (``metrics/decode_hbm_share.py``).
"""

from __future__ import annotations

from typing import Dict, List

from servebench import costs
from servebench.reference import draw
from servebench.reference import model as reference

score = reference.score
token_flops = costs.token_flops


def build_params(cfg, model: Dict, bits: int, seed: int, device) -> Dict:
    """The weights drawn from ``seed`` (``reference/draw.py``), each layer
    packed by the port's ``quantize_params`` as it is drawn; the tensors
    left dense in the model's dtype."""
    import torch

    from repro_torch.models import quantize_params

    dtype = getattr(torch, cfg.dtype)

    def pack(tree):
        return quantize_params(tree, cfg, bits)

    layers = []
    for i in range(model["n_layers"]):
        w = draw.draw_layer(model, seed, i, device)
        mlp = {k: {"w": w[k]} for k in ("w_gate", "w_up", "w_down")
               if k in w}
        layer = {"ln1": w["ln1"].to(dtype), "ln2": w["ln2"].to(dtype),
                 "mlp": mlp,
                 "attn": {k: {"w": w[k]} for k in ("wq", "wk", "wv", "wo")}}
        layers.append(pack({"layers": [layer]})["layers"][0])
        del w, layer, mlp
    head = draw.draw_head(model, seed, device)
    params = pack({"lm_head": {"w": head["lm_head"]}, "layers": []})
    params.update(embed=draw.draw_embed(model, seed, device).to(dtype),
                  layers=layers, final_norm=head["final_norm"].to(dtype))
    return params


def decode_step_bytes(model: Dict, engine: Dict, lanes: int,
                      contexts: List[int], step=None) -> int:
    return costs.decode_step_bytes(model, engine["weight_bits"],
                                   engine["kv_bits"], lanes, contexts)
