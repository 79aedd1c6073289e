"""The plain reference of a served decoder, in the configuration's
precision, with no cache.

It follows the model that the configuration's file states, as the port
builds it (``PERF.md`` lists where that departs from the published
architecture): RMSNorm scaled by ``1 + scale``, split-half rotary
embeddings, grouped-query attention (query head ``h`` reads KV head
``h // G``), a SwiGLU or a tanh-GELU MLP, an untied head.  Weights are
drawn again from the seed (``draw.py``) and rounded to their ``bits``-bit
codes and per-channel scales by this file's own arithmetic; K and V are
rounded to int8 per token and KV head with a bfloat16 scale where the
configuration keeps int8 pages, and attention over them takes the query
and the probabilities times V's scale in bfloat16.

Every product and sum is float32 (TF32 off).  What the configuration
keeps in its ``dtype`` is rounded to it where a step of the model hands
it on: the residual stream after every add, each norm's output, each
linear's output, q and k after the rotation, attention's output, the
MLP's activation, and the logits.  With a float32 configuration nothing
is rounded but the int8 attention's operands.

``score`` runs each sequence through every layer in turn, all sequences
at once a layer and attention in blocks of queries, so that it fits on
the card beside what is left of the engine.  A family whose layers hold
another block in place of the MLP hands ``score`` its own ``layers``
(``dense_layer``'s contract).  ``act_format="fp8"`` is the
control of ``check.py``: the same model with the input of every linear
(the head's too) in float8 e4m3 at a scale a row, the precision below
the configuration's bfloat16, where a faster GEMV would tempt a program
to take it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from servebench.reference import draw

QUERY_BLOCK = 512
FP8_MAX = 448.0


def plain_precision() -> None:
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def dequantized(w: torch.Tensor, bits: int) -> torch.Tensor:
    """``w`` ``(K, N)`` rounded to signed ``bits``-bit codes with one
    float32 scale per output column (absmax over K over the largest code;
    an all-zero column scale 1; round half to even), back in float32."""
    qmax = 2 ** (bits - 1) - 1
    wf = w.to(torch.float32)
    absmax = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    return torch.clamp(torch.round(wf / scale), -qmax, qmax).mul_(scale)


def kv_codes(t: torch.Tensor):
    """K or V ``(S, Hkv, Dh)`` as int8 codes per token and head (in
    float32) and their scale ``(S, Hkv, 1)``, kept in bfloat16 (in
    float32)."""
    absmax = t.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(t / scale), -127, 127)
    return q, scale.to(torch.bfloat16).to(torch.float32)


def kv_rounded(t: torch.Tensor) -> torch.Tensor:
    """K or V rounded to int8 per token and head, back in float32."""
    q, scale = kv_codes(t)
    return q * scale


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row of ``x`` through float8 e4m3 at a per-row scale."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / FP8_MAX, torch.ones_like(absmax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of ``(S, H, Dh)`` at positions 0..S-1."""
    s, _, dh = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, kv8: bool = False) -> torch.Tensor:
    """``q`` ``(S, Hq, Dh)``, ``k`` / ``v`` ``(S, Hkv, Dh)`` -> ``(S, Hq *
    Dh)``, in blocks of queries.  ``kv8``: K and V are read as int8 codes
    times their bfloat16 scale, the query and the probabilities times V's
    scale taken through bfloat16."""
    s, hq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    if kv8:
        q = to_bf16(q)
        k, k_scale = kv_codes(k)
        v, v_scale = kv_codes(v)
        ks = k_scale[:, :, 0].t()[:, None, None, :]    # (Hkv, 1, 1, S)
        vs = v_scale[:, :, 0].t()[:, None, None, :]
    kt = k.permute(1, 2, 0)                        # (Hkv, Dh, S)
    vt = v.permute(1, 0, 2)                        # (Hkv, S, Dh)
    out = torch.empty((s, hq, dh), dtype=torch.float32, device=q.device)
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(s, lo + QUERY_BLOCK)
        qb = q[lo:hi].reshape(hi - lo, hkv, g, dh).permute(1, 2, 0, 3)
        sc = torch.matmul(qb, kt[:, None, :, :hi])
        if kv8:
            sc = sc * ks[..., :hi]
        sc = sc * dh ** -0.5
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        if kv8:
            p = to_bf16(p * vs[..., :hi])
        ob = torch.matmul(p, vt[:, None, :hi])     # (Hkv, G, Sb, Dh)
        out[lo:hi] = ob.permute(2, 0, 1, 3).reshape(hi - lo, hq, dh)
    return out.reshape(s, hq * dh)


def dense_layer(model: Dict, seed: int, layer: int, device):
    """One layer's weights (``draw.draw_layer``), of which ``score`` reads
    ``ln1``, ``wq``, ``wk``, ``wv``, ``wo`` and ``ln2``, and its block
    after the attention: ``block(h, linear, rd)``, the MLP's output for
    the normed rows ``h``, each linear through ``linear`` and rounded by
    ``rd`` as the model hands it on."""
    w = draw.draw_layer(model, seed, layer, device)

    def block(h, linear, rd):
        up = linear(h, w["w_up"])
        if "w_gate" in w:
            act = rd(rd(F.silu(linear(h, w["w_gate"]))) * up)
        else:
            act = rd(F.gelu(up, approximate="tanh"))
        del up
        return linear(act, w["w_down"])

    return w, block


def score(model: Dict, engine: Dict, seed: int,
          sequences: Sequence[Sequence[int]], positions: Sequence[range],
          device, act_format: str = "model",
          extra: Optional[Sequence[Sequence[int]]] = None,
          keep: Optional[Sequence[Sequence[int]]] = None,
          layers: Callable = dense_layer) -> List[Dict]:
    """Logits of the model drawn from ``seed`` over each token sequence,
    read at ``positions[i]`` (positions of ``sequences[i]``, each
    predicting the token after it).

    Returns, for each sequence, ``best`` (the highest logit at each
    position), ``top`` (its token), ``next_logit`` (the logit of the
    sequence's own next token, which each position must have), where
    ``extra`` gives one token a position ``extra_logit`` (that token's
    logit), and where ``keep`` names some of the positions ``logits``
    (``(len(keep[i]), V)``, on the host).  ``model``: the configuration's
    sizes and ``dtype``; ``engine``: its ``weight_bits`` and ``kv_bits``;
    ``act_format``: ``model`` or ``fp8`` (the control); ``layers``: each
    layer's weights and block (:func:`dense_layer`).
    """
    if model.get("tie_embeddings"):
        raise ValueError("the reference draws an untied head")
    if act_format not in ("model", "fp8"):
        raise ValueError(f"act_format must be model or fp8, got "
                         f"{act_format!r}")
    plain_precision()
    dtype = getattr(torch, model.get("dtype", "float32"))

    def rd(t):
        return t if dtype == torch.float32 else t.to(dtype).to(torch.float32)

    lin_in = fp8_rows if act_format == "fp8" else (lambda t: t)
    bits, kv8 = engine["weight_bits"], engine["kv_bits"] == 8
    eps, theta = model["norm_eps"], model["rope_theta"]
    hq, hkv, dh = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    lens = [len(s) for s in sequences]
    cuts = torch.tensor([0] + lens).cumsum(0).tolist()
    tokens = torch.tensor([t for s in sequences for t in s], device=device)
    x = rd(draw.draw_embed(model, seed, device)[tokens].to(torch.float32))

    def linear(h, w):
        return rd(torch.matmul(lin_in(h), dequantized(w, bits)))

    for layer in range(model["n_layers"]):
        w, block = layers(model, seed, layer, device)
        h = rd(rms_norm(x, w["ln1"], eps))
        q, k, v = (linear(h, w[n]) for n in ("wq", "wk", "wv"))
        o = torch.empty((x.shape[0], hq * dh), dtype=torch.float32,
                        device=device)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            qi = rd(rope(q[lo:hi].reshape(-1, hq, dh), theta))
            ki = rd(rope(k[lo:hi].reshape(-1, hkv, dh), theta))
            vi = v[lo:hi].reshape(-1, hkv, dh)
            o[lo:hi] = rd(causal_attention(qi, ki, vi, kv8))
        del q, k, v
        x = rd(x + linear(o, w["wo"]))
        h = rd(rms_norm(x, w["ln2"], eps))
        x = rd(x + block(h, linear, rd))
        del w, block, h, o
    head = draw.draw_head(model, seed, device)
    w_head = dequantized(head["lm_head"], bits)
    out = []
    for i, (lo, pos) in enumerate(zip(cuts[:-1], positions)):
        pos = list(pos)
        rows = torch.tensor(pos, device=device, dtype=torch.long) + lo
        hf = rd(rms_norm(x[rows], head["final_norm"], eps))
        logits = rd(torch.matmul(lin_in(hf), w_head))
        best, top = logits.max(dim=-1)
        nxt = tokens[rows + 1][:, None]
        rec = {"best": best.cpu(), "top": top.cpu(),
               "next_logit": logits.gather(1, nxt)[:, 0].cpu()}
        if extra is not None:
            idx = torch.tensor(list(extra[i]), device=device)[:, None]
            rec["extra_logit"] = logits.gather(1, idx)[:, 0].cpu()
        if keep is not None:
            at = {p: j for j, p in enumerate(pos)}
            idx = torch.tensor([at[p] for p in keep[i]], device=device,
                               dtype=torch.long)
            rec["logits"] = logits[idx].cpu()
        out.append(rec)
    return out
