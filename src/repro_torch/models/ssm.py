"""Mamba2 (SSD — state-space duality) block: the chunked-scan path over a
whole sequence and the O(1)-state decode step (arXiv:2405.21060), as the
JAX package's ``models/ssm.py`` has them.

Per-head scalar decay A, state size ``ssm_state``, heads of width
``ssm_head_dim``.  :func:`ssd_chunked` splits the sequence into chunks:
within-chunk terms as masked (attention-like) products, cross-chunk terms
carried by a loop over per-chunk states.  With ``use_kernel`` it runs the
CUDA SSD-scan kernel (``repro_torch.kernels.ssd_scan``) instead.  Decode
is the exact recurrence ``h' = a·h + dt·x⊗B, y = C·h' + D·x``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.engine import EnginePlan
from repro_torch.models.layers import dense, init_linear, rms_norm_gated


def init_ssm(cfg: ModelConfig, gen: torch.Generator, dtype) -> dict:
    """One Mamba2 block's parameters, drawn on the generator's device, with
    the JAX package's distributions."""
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, cw = cfg.n_ssm_heads, cfg.conv_width
    conv_ch = di + 2 * st
    dev = gen.device
    conv_w = torch.randn((cw, conv_ch), generator=gen, device=dev,
                         dtype=torch.float32) * 0.2
    return {
        # order: [z (di), x (di), B (st), C (st), dt (nh)]
        "in_proj": init_linear(gen, d, 2 * di + 2 * st + nh, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "a_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((nh,), -2.0, dtype=torch.float32, device=dev),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm_scale": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": init_linear(gen, di, d, dtype),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, st = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di:2 * di]
    b_in = zxbcdt[..., 2 * di:2 * di + st]
    c_in = zxbcdt[..., 2 * di + st:2 * di + 2 * st]
    dt = zxbcdt[..., 2 * di + 2 * st:]
    return z, xs, b_in, c_in, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S; u ``(B, S, C)``, w ``(cw, C)``.
    Returns (silu(out), new_state), the state being the last ``cw - 1``
    inputs."""
    cw = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                      # (B, S+cw-1, C)
    s = u.shape[1]
    out = sum(full[:, i:i + s] * w[i][None, None] for i in range(cw))
    out = out + b[None, None]
    new_state = full[:, -(cw - 1):] if cw > 1 else torch.zeros_like(pad)
    return F.silu(out.to(torch.float32)).to(u.dtype), new_state


def _rounded(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and widened to float32: an operand of a
    contraction that JAX runs in ``dtype`` with float32 accumulation."""
    return t.to(dtype).to(torch.float32)


def ssd_chunked(
    xh: torch.Tensor,     # (B, S, H, P)  inputs per head
    dt: torch.Tensor,     # (B, S, H)     softplus'd timestep
    a: torch.Tensor,      # (H,)          negative decay rate
    b_in: torch.Tensor,   # (B, S, N)
    c_in: torch.Tensor,   # (B, S, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,    # (B, H, P, N) initial state
    *,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked algorithm.  Returns (y ``(B, S, H, P)`` in xh's dtype,
    h_final ``(B, H, P, N)`` float32).

    The plain path follows ``repro.models.ssm.ssd_chunked`` line for line:
    the decay statistics stay float32, the large operands are rounded to
    the model dtype and contracted with float32 sums.  ``use_kernel``
    computes the kernel's inputs ``xdt`` and ``la`` as that function does
    and runs ``ops.ssd_scan`` at this ``chunk``; the kernel starts from a
    zero state, so ``h0`` raises there.
    """
    bsz, s, nh, p = xh.shape
    n = b_in.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a "
                         f"multiple of chunk {chunk}")
    nc = s // chunk
    cdt = xh.dtype
    la = dt * a[None, None, :]                       # log decay, <= 0
    xdt = (xh.to(torch.float32) * dt[..., None]).to(cdt)

    if use_kernel:
        if h0 is not None:
            raise NotImplementedError(
                "ssd_chunked: the SSD-scan kernel starts from a zero state; "
                "an initial state h0 is not supported on the kernel route")
        from repro_torch.kernels.ssd_scan.ops import ssd_scan

        y, h_final = ssd_scan(xdt, la.to(torch.float32), b_in.to(cdt),
                              c_in.to(cdt), chunk=chunk)
        return y.to(xh.dtype), h_final

    lac = la.to(torch.float32).reshape(bsz, nc, chunk, nh)
    cum = torch.cumsum(lac, dim=2)                   # within-chunk cumulative
    total = cum[:, :, -1]                            # (B, nc, H)

    xc = _rounded(xdt, cdt).reshape(bsz, nc, chunk, nh, p)
    bc = _rounded(b_in, cdt).reshape(bsz, nc, chunk, n)
    cc = _rounded(c_in, cdt).reshape(bsz, nc, chunk, n)

    # intra-chunk (diagonal blocks): M[i,j] = C_i·B_j * exp(cum_i - cum_j)
    # for j <= i, heads in groups of <= 8 to bound the (L, L, H) tensor
    gb = _rounded(torch.einsum("bcin,bcjn->bcij", cc, bc), cdt)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xh.device))
    hg = min(8, nh)
    if nh % hg:
        raise ValueError(f"ssd_chunked: {nh} heads do not split into "
                         f"groups of {hg}")
    y_groups = []
    for h_lo in range(0, nh, hg):
        cum_i = cum[..., h_lo:h_lo + hg]             # (B, nc, L, hg)
        dec = cum_i[:, :, :, None, :] - cum_i[:, :, None, :, :]
        m = torch.where(causal[None, None, :, :, None], torch.exp(dec),
                        torch.zeros((), device=xh.device))
        w = gb[..., None] * _rounded(m, cdt)         # (B, nc, L, L, hg)
        y_groups.append(torch.einsum("bcijh,bcjhp->bcihp", w,
                                     xc[:, :, :, h_lo:h_lo + hg]))
    y_intra = torch.cat(y_groups, dim=3)             # (B, nc, L, H, P)

    # chunk states: sum_j exp(total - cum_j) * B_j ⊗ x_j
    decay_to_end = _rounded(torch.exp(total[:, :, None] - cum), cdt)
    chunk_state = torch.einsum("bcjn,bcjhp->bchpn", bc,
                               decay_to_end[..., None] * xc)

    # inter-chunk scan over the carried state
    h = (torch.zeros((bsz, nh, p, n), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.to(torch.float32))
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + chunk_state[:, c]
    h_enter = torch.stack(h_enter, dim=1)            # (B, nc, H, P, N)

    # inter-chunk contribution to the outputs
    ch = torch.einsum("bcin,bchpn->bcihp", cc, _rounded(h_enter, cdt))
    y_inter = _rounded(torch.exp(cum), cdt)[..., None] * ch
    y = (y_intra + y_inter).reshape(bsz, s, nh, p)
    return y.to(xh.dtype), h


def ssm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                plan: Optional[EnginePlan] = None, *,
                use_kernel: bool = False) -> torch.Tensor:
    """Whole-sequence path without a cache."""
    y, _, _ = _ssm_run(params, x, cfg, plan, conv_state=None, h0=None,
                       use_kernel=use_kernel)
    return y


def ssm_decode_step(params, x: torch.Tensor, cfg: ModelConfig,
                    conv_state: torch.Tensor, h: torch.Tensor,
                    plan: Optional[EnginePlan] = None):
    """x ``(B, 1, D)``; the exact recurrence.  Returns (y, conv_state, h)."""
    return _ssm_run(params, x, cfg, plan, conv_state=conv_state, h0=h,
                    decode=True)


def _ssm_run(params, x, cfg, plan, conv_state, h0, decode: bool = False,
             use_kernel: bool = False):
    bsz, s, _ = x.shape
    nh, p, st = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    zxbcdt = dense(params["in_proj"], x, plan)
    z, xs, b_in, c_in, dt = _split_proj(zxbcdt, cfg)

    conv_in = torch.cat([xs, b_in, c_in], dim=-1)
    conv_out, new_conv_state = _causal_conv(
        conv_in, params["conv_w"], params["conv_b"], conv_state)
    di = cfg.d_inner
    xs = conv_out[..., :di]
    b_in = conv_out[..., di:di + st]
    c_in = conv_out[..., di + st:]

    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])  # (B, S, H)
    a = -torch.exp(params["a_log"])                            # (H,)
    xh = xs.reshape(bsz, s, nh, p)
    d_skip = params["d_skip"][None, None, :, None]

    if decode:
        # h' = exp(dt·a)·h + dt·x ⊗ B ;  y = C·h' + D·x
        la = torch.exp(dt[:, 0] * a[None])                     # (B, H)
        xdt = xh[:, 0] * dt[:, 0, :, None]                     # (B, H, P)
        h = (h0.to(torch.float32) * la[:, :, None, None]
             + torch.einsum("bhp,bn->bhpn", xdt,
                            b_in[:, 0].to(torch.float32)))
        y = torch.einsum("bn,bhpn->bhp", c_in[:, 0].to(torch.float32), h)
        y = y[:, None] + d_skip * xh.to(torch.float32)
        h_final = h
    else:
        y, h_final = ssd_chunked(xh, dt, a, b_in, c_in, cfg.ssm_chunk, h0,
                                 use_kernel=use_kernel)
        y = y.to(torch.float32) + d_skip * xh.to(torch.float32)

    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rms_norm_gated(y, z, params["norm_scale"], cfg.norm_eps)
    out = dense(params["out_proj"], y, plan)
    return out, new_conv_state, h_final
