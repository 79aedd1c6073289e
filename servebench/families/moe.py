"""The moe family: the dense family's attention with a mixture of experts
in place of the MLP, as the port's ``models/moe.py`` states it.

**Draws.**  One generator a layer (``draw.generator(seed, layer)``), in
this order: ``ln1``, ``wq``, ``wk``, ``wv``, ``wo``, ``ln2`` as the dense
family draws them; the ``router`` ``(D, E)``; then expert by expert its
``w_gate`` ``(D, F)``, ``w_up`` ``(D, F)`` and ``w_down`` ``(F, D)``
(``F`` = ``moe_d_ff``); then, where ``n_shared_experts`` is set, the
shared SwiGLU's ``w_gate``, ``w_up`` ``(D, d_ff)`` and ``w_down``.
Distributions as ``reference/draw.py``: linears ``N(0, 1/d_in)``, norm
scales ``N(0, 0.1^2)``, in float32 rounded to bfloat16.  The program
gets each expert packed as it is drawn, the experts of a linear stacked
into the one ``PackedLinear`` that ``models/moe.py`` ``_stack_packed``
builds; the router stays dense, as ``quantize_params`` leaves it.

**The reference block**, in float32 with TF32 off, rounded to the
configuration's dtype where ``reference/model.py`` rounds (each linear's
output, the MLP's activation, the residual stream): router logits (a
dense linear), softmax, top-k by a stable descending sort (the lower
expert first on a tie), the gates renormalised over the k and rounded;
each routed expert's SwiGLU on its dequantised codes, weighted by its
gate and summed in float32, the sum rounded; the shared expert's SwiGLU
added after.  The control feeds float8 to every packed linear (the
experts, attention, the shared expert and the head), not to the router.

**Dropless.**  The reference computes every routed pair, as the
published models infer.  The port keeps a pair while its rank among its
batch row's pairs of one expert is below the capacity ``max(8,
ceil(S·k/E·capacity_factor))`` rounded up to 8, so a moe configuration
must set ``capacity_factor`` ≥ ``n_experts / top_k``: the capacity is then
at least ``S`` (``prefill_chunk`` in a chunk step, 1 in a decode step)
and no pair is dropped.  A configuration that lets the program drop pairs
reads not correct, and that is the right verdict.

Windowed attention is not this family's: ``score`` refuses a
configuration with a ``sliding_window``.

The module imports nothing of the program but, inside ``build_params``,
the port's packing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from servebench import costs
from servebench.reference import draw
from servebench.reference import model as reference

EXPERT_LINEARS = ("w_gate", "w_up", "w_down")


def attention_linears(model: Dict):
    """``(K, N)`` of one layer's attention linears."""
    d, dh = model["d_model"], model["head_dim"]
    hq, hkv = model["n_heads"], model["n_kv_heads"]
    return [(d, hq * dh), (d, hkv * dh), (d, hkv * dh), (hq * dh, d)]


def swiglu_linears(d: int, f: int):
    """``(K, N)`` of a SwiGLU's ``w_gate``, ``w_up`` and ``w_down``."""
    return [(d, f), (d, f), (f, d)]


def shared_linears(model: Dict):
    if not model.get("n_shared_experts"):
        return []
    return swiglu_linears(model["d_model"], model["d_ff"])


class LayerDraws:
    """One layer's weights, drawn in the module's fixed order as they are
    asked for: :meth:`attention`, :meth:`router`, :meth:`expert` once an
    expert, :meth:`shared`."""

    def __init__(self, model: Dict, seed: int, layer: int, device):
        self.model = model
        self.gen = draw.generator(seed, layer, device)

    def _linear(self, d_in: int, d_out: int) -> torch.Tensor:
        return draw._linear(self.gen, d_in, d_out, torch.bfloat16)

    def attention(self) -> Dict[str, torch.Tensor]:
        d = self.model["d_model"]
        out = {"ln1": draw._normal(self.gen, (d,), 0.1, torch.bfloat16)}
        for name, (k, n) in zip(("wq", "wk", "wv", "wo"),
                                attention_linears(self.model)):
            out[name] = self._linear(k, n)
        out["ln2"] = draw._normal(self.gen, (d,), 0.1, torch.bfloat16)
        return out

    def router(self) -> torch.Tensor:
        return self._linear(self.model["d_model"], self.model["n_experts"])

    def expert(self) -> Dict[str, torch.Tensor]:
        shapes = swiglu_linears(self.model["d_model"], self.model["moe_d_ff"])
        return {name: self._linear(k, n)
                for name, (k, n) in zip(EXPERT_LINEARS, shapes)}

    def shared(self) -> Optional[Dict[str, torch.Tensor]]:
        shapes = shared_linears(self.model)
        return {name: self._linear(k, n)
                for name, (k, n) in zip(EXPERT_LINEARS, shapes)} or None


# ----------------------------------------------------------------- program
def build_params(cfg, model: Dict, bits: int, seed: int, device) -> Dict:
    """The port's params tree of the weights drawn from ``seed``: each
    expert packed as it is drawn and a linear's experts stacked, the rest
    of a layer packed by ``quantize_params`` once the layer is drawn."""
    from repro_torch.engine import pack_linear
    from repro_torch.models import quantize_params
    from repro_torch.models.moe import _stack_packed

    dtype = getattr(torch, cfg.dtype)

    def pack(tree):
        return quantize_params(tree, cfg, bits)

    layers = []
    for i in range(model["n_layers"]):
        draws = LayerDraws(model, seed, i, device)
        w = draws.attention()
        moe = {"router": {"w": draws.router().to(dtype)}}
        experts = {name: [] for name in EXPERT_LINEARS}
        for _ in range(model["n_experts"]):
            for name, mat in draws.expert().items():
                experts[name].append(pack_linear(mat, bits))
        moe.update({name: _stack_packed(lins)
                    for name, lins in experts.items()})
        shared = draws.shared()
        if shared is not None:
            moe["shared"] = {name: {"w": mat} for name, mat in shared.items()}
        layer = {"ln1": w["ln1"].to(dtype), "ln2": w["ln2"].to(dtype),
                 "attn": {k: {"w": w[k]} for k in ("wq", "wk", "wv", "wo")},
                 "moe": moe}
        layers.append(pack({"layers": [layer]})["layers"][0])
        del w, moe, experts, shared, layer
    head = draw.draw_head(model, seed, device)
    params = pack({"lm_head": {"w": head["lm_head"]}, "layers": []})
    params.update(embed=draw.draw_embed(model, seed, device).to(dtype),
                  layers=layers, final_norm=head["final_norm"].to(dtype))
    return params


# --------------------------------------------------------------- reference
def _moe_block(h: torch.Tensor, draws: LayerDraws, model: Dict, linear,
               rd) -> torch.Tensor:
    """The block's output for the normed rows ``h`` ``(T, D)``: every
    routed pair, then the shared expert.  Experts are drawn in order
    whether or not a row routes to them."""
    k = model["top_k"]
    logits = rd(torch.matmul(h, draws.router().to(torch.float32)))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    gates = rd(top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9))
    y = torch.zeros_like(h)
    for expert in range(model["n_experts"]):
        w = draws.expert()
        rows, slot = torch.nonzero(top_i == expert, as_tuple=True)
        if len(rows):
            xe = h[rows]
            act = rd(rd(F.silu(linear(xe, w["w_gate"])))
                     * linear(xe, w["w_up"]))
            y.index_add_(0, rows, linear(act, w["w_down"])
                         * gates[rows, slot, None])
        del w
    y = rd(y)
    shared = draws.shared()
    if shared is not None:
        act = rd(rd(F.silu(linear(h, shared["w_gate"])))
                 * linear(h, shared["w_up"]))
        y = rd(y + linear(act, shared["w_down"]))
    return y


def moe_layer(model: Dict, seed: int, layer: int, device):
    """``reference/model.py`` ``dense_layer``'s contract for a moe layer:
    its attention's weights, and :func:`_moe_block` in place of the
    MLP."""
    draws = LayerDraws(model, seed, layer, device)

    def block(h, linear, rd):
        return _moe_block(h, draws, model, linear, rd)

    return draws.attention(), block


def score(model: Dict, engine: Dict, seed: int,
          sequences, positions, device, act_format: str = "model",
          extra=None, keep=None) -> List[Dict]:
    """``reference/model.py`` ``score`` (its contract, attention, head and
    records) with this module's block in place of the MLP."""
    if model.get("sliding_window"):
        raise ValueError("windowed attention is not the moe family's")
    return reference.score(model, engine, seed, sequences, positions, device,
                           act_format=act_format, extra=extra, keep=keep,
                           layers=moe_layer)


# ------------------------------------------------------------------- costs
def matmul_params(model: Dict) -> int:
    """Parameters a token multiplies: every layer's attention, router, its
    ``top_k`` experts and the shared expert, and the head."""
    d = model["d_model"]
    per_layer = (sum(k * n for k, n in attention_linears(model))
                 + d * model["n_experts"]
                 + model["top_k"] * sum(k * n for k, n in swiglu_linears(
                     d, model["moe_d_ff"]))
                 + sum(k * n for k, n in shared_linears(model)))
    return model["n_layers"] * per_layer + d * model["vocab_size"]


def token_flops(model: Dict, position: int) -> int:
    """Model FLOPs of one token at ``position``: its active parameters at
    2 FLOPs each and its attention over ``position + 1`` keys."""
    return 2 * matmul_params(model) + costs.attention_flops(model,
                                                            position + 1)


def decode_step_bytes(model: Dict, engine: Dict, lanes: int,
                      contexts: List[int], step) -> Optional[int]:
    """Bytes a paged decode step must move: every dense code and scale
    once (attention, the shared expert, the head) with x and y at M =
    ``lanes``; the router's bfloat16 weight, its x and its logits; the
    codes and scales of each (layer, expert) the step's grouped launches
    read (``step.experts_touched``, the engine's count) and the
    ``lanes x top_k`` routed rows into and out of each grouped launch; the
    ``lanes`` embedding rows; each decoding lane's K/V at ``contexts`` and
    the new K/V.  None where the step has no count of touched experts."""
    if step is None or step.experts_touched is None:
        return None
    bits, n_layers = engine["weight_bits"], model["n_layers"]
    d, e = model["d_model"], model["n_experts"]
    dense = (attention_linears(model) + shared_linears(model)) * n_layers
    dense.append((d, model["vocab_size"]))
    total = sum(costs.bitplane_gemv(lanes, k, n, bits, 2, 2)[0]
                for k, n in dense)
    total += n_layers * 2 * (d * e + lanes * (d + e))
    pairs = lanes * model["top_k"]
    for k, n in swiglu_linears(d, model["moe_d_ff"]):
        total += n_layers * 2 * pairs * (k + n)
        total += step.experts_touched * (k * n * bits // 8 + 4 * n)
    total += lanes * d * 2
    per_token = costs.kv_bytes_per_token(model, engine["kv_bits"])
    return total + (sum(contexts) + len(contexts)) * per_token
