"""Shared building blocks: linears (dense or engine-packed), RMSNorm (plain
and gated), SwiGLU, rotary embeddings and initialisers.

Every matmul of the model goes through :func:`dense`, which dispatches a
plain ``{"w", "bias"?}`` weight to ``torch.matmul`` and an engine
:class:`~repro_torch.engine.PackedLinear` to ``EnginePlan.apply``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.collectives import sum_over
from repro_torch.engine import EnginePlan, as_packed, is_packed, plan_for_bits


def dense(p, x: torch.Tensor, plan: Optional[EnginePlan] = None
          ) -> torch.Tensor:
    """``y = x @ W [+ bias]``; ``W`` may be engine-packed."""
    if is_packed(p):
        lin = as_packed(p, bits_hint=plan.bits if plan else None)
        if plan is None:
            # packed weights without a plan: the weight's own precision on
            # the device's default backend
            plan = plan_for_bits(lin.bits, device=x.device)
        return plan.apply(lin, x)  # the plan adds the bias
    w, bias = (p["w"], p.get("bias")) if isinstance(p, dict) else (p, None)
    y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dt)


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's gated RMSNorm: ``norm(x) * silu(z)``, the gate taken in
    float32 and rounded to x's dtype."""
    return rms_norm(x, scale, eps) * F.silu(z.to(torch.float32)).to(x.dtype)


def row_dense(p, x: torch.Tensor, plan: Optional[EnginePlan],
              group) -> torch.Tensor:
    """A row-parallel linear on this rank's slice of the input features,
    summed over ``group`` (None: the whole linear, :func:`dense`).  A
    packed one runs the ``sharded`` backend, which sums its float32
    partials itself; a dense one is multiplied in float32 and summed
    here (:func:`~repro_torch.dist.collectives.sum_over`, so that under
    autograd each rank's partial takes the whole gradient).  The bias,
    whole on every rank, is added once, after the sum."""
    if group is None:
        return dense(p, x, plan)
    if is_packed(p):
        if (plan is None or plan.backend != "sharded"
                or as_packed(p).shard != "row"):
            raise ValueError(
                "a row-parallel packed linear on a mesh runs through the "
                "sharded backend (EngineConfig(sharded=True))")
        return dense(p, x, plan)
    y = sum_over(torch.matmul(x.to(torch.float32),
                              p["w"].to(torch.float32)), group)
    y = y.to(x.dtype)
    if p.get("bias") is not None:
        y = y + p["bias"].to(y.dtype)
    return y


def swiglu(p: dict, x: torch.Tensor, plan: Optional[EnginePlan] = None,
           down: Optional[Callable] = None) -> torch.Tensor:
    """The gated (SiLU) MLP, or the plain GELU one without ``w_gate``.
    ``down(w, h)``: how ``w_down`` is applied (default :func:`dense`; a
    rank of a mesh passes its row-parallel sum)."""
    if down is None:
        def down(w, h):
            return dense(w, h, plan)
    if "w_gate" not in p:
        # plain GELU MLP, in the tanh form: ``jax.nn.gelu``'s default
        return down(p["w_down"], F.gelu(dense(p["w_up"], x, plan),
                                        approximate="tanh"))
    gate = dense(p["w_gate"], x, plan)
    up = dense(p["w_up"], x, plan)
    return down(p["w_down"], F.silu(gate) * up)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half rotary embedding; x ``(B, S, H, Dh)``, positions ``(B, S)``."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                     # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs     # (B,S,Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                bias: bool = False) -> dict:
    """``{"w": (d_in, d_out)[, "bias"]}`` with ``w ~ N(0, 1/d_in)``, drawn
    on the generator's device."""
    std = 1.0 / (d_in ** 0.5)
    w = (torch.randn((d_in, d_out), generator=gen, device=gen.device,
                     dtype=torch.float32) * std).to(dtype)
    if bias:
        return {"w": w, "bias": torch.zeros((d_out,), dtype=dtype,
                                            device=gen.device)}
    return {"w": w}


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device,
                        dtype=torch.float32) * 0.02).to(dtype)
