"""Shared building blocks: linears (dense or engine-packed), RMSNorm (plain
and gated), SwiGLU, rotary embeddings and initialisers.

Every matmul of the model goes through :func:`dense`, which dispatches a
plain ``{"w", "bias"?}`` weight to ``torch.matmul`` and an engine
:class:`~repro_torch.engine.PackedLinear` to ``EnginePlan.apply``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def swiglu(p: dict, x: torch.Tensor, plan: Optional[EnginePlan] = None
           ) -> torch.Tensor:
    if "w_gate" not in p:  # plain GELU MLP
        return dense(p["w_down"], F.gelu(dense(p["w_up"], x, plan)), plan)
    gate = dense(p["w_gate"], x, plan)
    up = dense(p["w_up"], x, plan)
    return dense(p["w_down"], F.silu(gate) * up, plan)


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
