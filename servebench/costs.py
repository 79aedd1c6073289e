"""The yardstick's arithmetic: the card's peaks, what a linear of the
bit-plane GEMV must move and compute, a model's parameters and FLOPs a
token, and the bytes of its K/V.

The GEMV's cost is a frozen copy of the port's
``roofline/kernel_costs.py`` ``bitplane_gemv`` (each input byte read
once, each output byte written once, a multiply-add two operations), so
that a change to the program cannot move the benchmark's bounds.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bitplane_gemv(m: int, k: int, n: int, bits: int, x_bytes: int,
                  out_bytes: int) -> Tuple[int, int]:
    """``(bytes, operations)`` of ``(M, K) @ unpack(K·bits/8, N) * scale``:
    the codes, the float32 scales, x and y."""
    return (k * n * bits // 8 + 4 * n + m * k * x_bytes + m * n * out_bytes,
            2 * m * k * n)


def bound_s(cost: Tuple[int, int]) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the peak rate."""
    nbytes, ops = cost
    return max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS)


def layer_linears(model: Dict) -> List[Tuple[str, int, int]]:
    """``(name, K, N)`` of one decoder layer's linears, in launch order."""
    d, dh, f = model["d_model"], model["head_dim"], model["d_ff"]
    hq, hkv = model["n_heads"], model["n_kv_heads"]
    out = [("wq", d, hq * dh), ("wk", d, hkv * dh), ("wv", d, hkv * dh),
           ("wo", hq * dh, d)]
    if model["mlp_gated"]:
        out.append(("w_gate", d, f))
    out += [("w_up", d, f), ("w_down", f, d)]
    return out


def head_linear(model: Dict) -> Tuple[str, int, int]:
    return ("lm_head", model["d_model"], model["vocab_size"])


def matmul_params(model: Dict) -> int:
    """Parameters a token multiplies: every layer's linears and the head
    (the embedding is a lookup)."""
    per_layer = sum(k * n for _, k, n in layer_linears(model))
    _, k, n = head_linear(model)
    return model["n_layers"] * per_layer + k * n


def attention_flops(model: Dict, keys: int) -> int:
    """FLOPs of one query token attending ``keys`` keys in every layer
    (scores and the weighted sum, a multiply-add two)."""
    return (4 * keys * model["n_heads"] * model["head_dim"]
            * model["n_layers"])


def token_flops(model: Dict, position: int) -> int:
    """Model FLOPs of one token at ``position`` (it attends position + 1
    keys): its linears and its attention."""
    return 2 * matmul_params(model) + attention_flops(model, position + 1)


def kv_bytes_per_token(model: Dict, kv_bits: int) -> int:
    """Bytes of one token's K and V over all layers; int8 pages add a
    bfloat16 scale a token, head and tensor."""
    per = model["n_kv_heads"] * model["head_dim"]
    if kv_bits == 8:
        return model["n_layers"] * 2 * (per + 2 * model["n_kv_heads"])
    return model["n_layers"] * 2 * per * 2


def decode_step_bytes(model: Dict, bits: int, kv_bits: int,
                      lanes: int, contexts: List[int]) -> int:
    """Bytes a paged decode step must move: every code and scale once (the
    layers' linears and the head), the ``lanes`` embedding rows and
    activations in and logits out at the GEMV's shapes, each decoding
    lane's cached K/V at its real length ``contexts`` and the new K/V."""
    total = 0
    shapes = [(k, n) for _, k, n in layer_linears(model)] * model["n_layers"]
    shapes.append(head_linear(model)[1:])
    for k, n in shapes:
        total += bitplane_gemv(lanes, k, n, bits, 2, 2)[0]
    total += lanes * model["d_model"] * 2
    per_token = kv_bytes_per_token(model, kv_bits)
    total += sum(contexts) * per_token + len(contexts) * per_token
    return total
