"""PyTorch port vs JAX: the Mamba2 SSD scan.

The same numpy-seeded inputs go through

* the port's plain version (``kernels/ssd_scan/ref.py``, the float64
  per-step recurrence) and JAX ``ssd_scan_ref`` (the same recurrence in
  numpy): float64 on both sides, rtol = atol = 1e-6 after the port's cast
  of its outputs to float32, the kernel's type;
* the port's ``ops.ssd_scan`` on CPU tensors and JAX ``ssd_scan(...,
  interpret=True)``, the chunked Pallas kernel interpreted on the CPU in
  float32: 1e-4 of the largest output (chunked float32 sums and
  exponentials of float32 cumulative decays against the exact recurrence);
* the port's ``ssd_chunked`` and JAX ``ssd_chunked`` in float32, with and
  without an initial state: rtol = atol = 1e-5 (float32 sums in another
  order), and the port's kernel route on CPU tensors (``use_kernel``,
  which reaches ``ops.ssd_scan``'s plain version) against the JAX function
  at the 1e-4 of the second case;
* ``_chunk_parallel_model``, the CUDA kernel's arithmetic in torch on the
  CPU (``csrc/ssd_scan.cu``: chunk states, the scan over chunks, the
  outputs; cum by warp shuffles; each float32 operand of a bf16 product
  split into bf16 hi + lo, float32 inputs split too; sums in the kernel's
  order of 16-step blocks), against JAX ``ssd_scan(..., interpret=True)``
  and ``ssd_scan_ref`` at the same 1e-4 of the largest output, for bf16
  and float32 inputs; and its variant with one bf16 rounding of the
  decayed C B^T tile, which misses that tolerance: why the kernel splits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.ssm import ssd_chunked

TOL = dict(rtol=1e-5, atol=1e-5)


def _scan_inputs(bsz, s, nh, p, n, seed=0):
    rng = np.random.default_rng(seed)
    xdt = (0.1 * rng.standard_normal((bsz, s, nh, p))).astype(np.float32)
    la = (-0.2 * rng.random((bsz, s, nh))).astype(np.float32)
    b_in = rng.standard_normal((bsz, s, n)).astype(np.float32)
    c_in = rng.standard_normal((bsz, s, n)).astype(np.float32)
    return xdt, la, b_in, c_in


def _scale_tol(ref):
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("shape", [(2, 64, 3, 8, 16), (1, 48, 2, 16, 8)])
def test_ref_matches_jax_ref(shape):
    inputs = _scan_inputs(*shape, seed=sum(shape))
    y, h = ssd_scan_ref(*(torch.from_numpy(a) for a in inputs))
    ry, rh = jax_ssd_ref(*inputs)
    np.testing.assert_allclose(y.numpy(), ry, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), rh, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("shape", [(2, 64, 3, 8, 16), (1, 128, 2, 16, 32)])
def test_ops_matches_jax_interpret(chunk, shape):
    inputs = _scan_inputs(*shape, seed=chunk + shape[1])
    y, h = ssd_scan(*(torch.from_numpy(a) for a in inputs), chunk=chunk)
    ry, rh = jax_ssd_scan(*(jnp.asarray(a) for a in inputs), chunk=chunk,
                          interpret=True)
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ry),
                               **_scale_tol(np.asarray(ry)))
    np.testing.assert_allclose(h.numpy(), np.asarray(rh),
                               **_scale_tol(np.asarray(rh)))


def _chunked_inputs(bsz, s, nh, p, n, seed):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((bsz, s, nh, p)).astype(np.float32)
    dt = (0.05 + 0.2 * rng.random((bsz, s, nh))).astype(np.float32)
    a = -(0.5 + rng.random(nh)).astype(np.float32)
    b_in = rng.standard_normal((bsz, s, n)).astype(np.float32)
    c_in = rng.standard_normal((bsz, s, n)).astype(np.float32)
    h0 = rng.standard_normal((bsz, nh, p, n)).astype(np.float32)
    return xh, dt, a, b_in, c_in, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape,chunk", [((2, 64, 8, 16, 16), 16),
                                         ((1, 48, 16, 8, 8), 16),
                                         ((2, 32, 4, 16, 16), 64)])
def test_ssd_chunked_matches_jax(with_h0, shape, chunk):
    *args, h0 = _chunked_inputs(*shape, seed=chunk + shape[2])
    h0 = h0 if with_h0 else None
    y, h = ssd_chunked(*(torch.from_numpy(a) for a in args), chunk,
                       None if h0 is None else torch.from_numpy(h0))
    ry, rh = jax_ssd_chunked(*(jnp.asarray(a) for a in args), chunk,
                             None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)


@pytest.mark.parametrize("shape,chunk", [((2, 64, 8, 16, 16), 16),
                                         ((1, 96, 2, 8, 16), 32)])
def test_ssd_chunked_kernel_route_matches_jax(shape, chunk):
    *args, _ = _chunked_inputs(*shape, seed=chunk)
    y, h = ssd_chunked(*(torch.from_numpy(a) for a in args), chunk,
                       use_kernel=True)
    ry, rh = jax_ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry),
                               **_scale_tol(np.asarray(ry)))
    np.testing.assert_allclose(h.numpy(), np.asarray(rh),
                               **_scale_tol(np.asarray(rh)))


def test_ssd_chunked_kernel_route_refuses_h0():
    *args, h0 = _chunked_inputs(1, 32, 2, 8, 8, seed=1)
    with pytest.raises(NotImplementedError, match="h0"):
        ssd_chunked(*(torch.from_numpy(a) for a in args), 16,
                    torch.from_numpy(h0), use_kernel=True)


# ----------------------------------------- the CUDA kernel's arithmetic
MAX_CHUNK = 256    # csrc/ssd_scan.cu: one thread a step in cum
WARP = 32
LOG2E = np.float32(1.4426950408889634)


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _split(t):
    """bf16 hi and what is left after it, as bf16 (both as float32)."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _kernel_cum(la):
    """The kernel's inclusive cumsum over the last axis (<= 256 steps):
    a Hillis-Steele scan of 32 steps a warp (shuffles), then the totals of
    the earlier warps added in warp order."""
    lp = la.shape[-1]
    v = torch.nn.functional.pad(la, (0, MAX_CHUNK - lp))
    v = v.reshape(*la.shape[:-1], MAX_CHUNK // WARP, WARP)
    off = 1
    while off < WARP:
        v = v + torch.nn.functional.pad(v[..., :-off], (off, 0))
        off *= 2
    pre, run = [torch.zeros_like(v[..., 0, 0])], torch.zeros_like(v[..., 0, 0])
    for w in range(1, MAX_CHUNK // WARP):
        run = run + v[..., w - 1, -1]
        pre.append(run)
    cum = torch.stack(pre, -1)[..., None] + v
    return cum.reshape(*la.shape[:-1], MAX_CHUNK)[..., :lp]


def _chunk_parallel_model(xdt, la, b_in, c_in, chunk, *, f32_inputs=False,
                          split_g=True):
    """csrc/ssd_scan.cu's three passes in float32 torch on numpy inputs.

    bf16 inputs (``f32_inputs`` False) must hold bf16 values: C B^T then
    has exact operands.  Every product of a float32 operand (w xdt, the
    entering state, the decayed C B^T) takes its bf16 hi and then its lo;
    with float32 inputs C, B and xdt are split too and a product of two
    split operands is hi hi + lo hi + hi lo.  ``split_g`` False rounds the
    decayed C B^T to bf16 once instead.  Sums run over 16-step blocks in
    the kernel's order, each block one einsum (one mma.sync).  The output
    pass takes its decays as powers of 2 of cum * log2(e).  A chunk over
    ``MAX_CHUNK`` steps is cut to ``MAX_CHUNK``, as the launcher cuts it;
    where that leaves a shorter last chunk, its steps past S are zeros
    (la 0 too), which the kernel's masks by index come to."""
    xdt, la, b_in, c_in = (torch.from_numpy(np.asarray(a, np.float32))
                           for a in (xdt, la, b_in, c_in))
    bsz, s, nh, p = xdt.shape
    n = b_in.shape[-1]
    lc = min(chunk, s, MAX_CHUNK)
    nc, lp = -(-s // lc), -(-lc // 16) * 16
    sp = nc * lc                                    # S in whole chunks
    xdt, la, b_in, c_in = (
        torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, sp - s))
        for t in (xdt, la, b_in, c_in))
    pad = (0, 0, 0, 0, 0, lp - lc)

    def chunks(t, width):          # (B, S, ...) -> (B, nc, lp, ...)
        t = t.reshape(bsz, nc, lc, *t.shape[2:])
        return torch.nn.functional.pad(t, pad[6 - 2 * width - 2:])

    x = chunks(xdt, 2)                              # (B, nc, lp, H, P)
    a = chunks(la, 1).permute(0, 1, 3, 2)           # (B, nc, H, lp)
    bm, cm = chunks(b_in, 1), chunks(c_in, 1)       # (B, nc, lp, N)
    split_in = _split if f32_inputs else (lambda t: (t, None))
    bhi, blo = split_in(bm)
    chi, clo = split_in(cm)
    xhi, xlo = split_in(x)
    cum = _kernel_cum(a)
    total = cum[..., lc - 1]                        # (B, nc, H)

    # pass 1: S = sum_j (w_j xdt_j) (x) B_j, w_j = exp(total - cum_j)
    w = torch.exp(total[..., None] - cum)
    wh, wl = _split(x.permute(0, 1, 3, 2, 4) * w[..., None])   # (B,nc,H,lp,P)
    st = torch.zeros((bsz, nc, nh, p, n))
    for k in range(lp // 16):
        j = slice(16 * k, 16 * k + 16)
        terms = [(wh, bhi), (wl, bhi)] + ([(wh, blo)] if f32_inputs else [])
        for u, v in terms:
            st = st + torch.einsum("bchjp,bcjn->bchpn", u[..., j, :],
                                   v[:, :, j])
    # pass 2: the states entering the chunks
    h = torch.zeros((bsz, nh, p, n))
    enter = []
    for c in range(nc):
        enter.append(h)
        h = h * torch.exp(total[:, c])[..., None, None] + st[:, c]
    hhi, hlo = _split(torch.stack(enter, 1))        # (B, nc, H, P, N)
    # pass 3: exp(cum_i) (C_i . h), then the decayed C B^T times xdt
    acc = torch.zeros((bsz, nc, nh, lp, p))
    # bf16 inputs (wgmma): every k step of C h_hi^T, then of C h_lo^T;
    # float32 inputs (mma.sync): hi, lo and C_lo h_hi a k step
    steps = ([[(chi, hhi)], [(chi, hlo)]] if not f32_inputs
             else [[(chi, hhi), (chi, hlo), (clo, hhi)]])
    for terms in steps:
        for k in range(n // 16):
            q = slice(16 * k, 16 * k + 16)
            for u, v in terms:
                acc = acc + torch.einsum("bcin,bchpn->bchip", u[..., q],
                                         v[..., q])
    cum2 = cum * LOG2E                              # exp(a - b) = 2^(a' - b')
    acc = acc * torch.exp2(cum2)[..., None]
    idx = torch.arange(lp)
    for jb in range(lp // 16):
        j = slice(16 * jb, 16 * jb + 16)
        rows = slice(16 * jb, lp)                   # the row tiles >= jb
        g = torch.zeros((bsz, nc, lp - 16 * jb, 16))
        for k in range(n // 16):
            q = slice(16 * k, 16 * k + 16)
            terms = [(chi, bhi)] + ([(clo, bhi), (chi, blo)] if f32_inputs
                                    else [])
            for u, v in terms:
                g = g + torch.einsum("bcin,bcjn->bcij", u[:, :, rows, q],
                                     v[:, :, j, q])
        dec = torch.exp2(cum2[..., rows, None] - cum2[..., None, j])
        keep = idx[rows, None] >= idx[None, j]
        gd = torch.where(keep, g[:, :, None] * dec, torch.zeros(()))
        ghi, glo = _split(gd) if split_g else (_bf16(gd), None)
        terms = [(ghi, xhi)] + ([(glo, xhi)] if split_g else []) + (
            [(ghi, xlo)] if f32_inputs else [])
        for u, v in terms:
            acc[..., rows, :] = acc[..., rows, :] + torch.einsum(
                "bchij,bcjhp->bchip", u, v[:, :, j])
    y = acc[..., :lc, :].permute(0, 1, 3, 2, 4).reshape(bsz, sp, nh, p)
    y = y[:, :s]
    return y.numpy(), h.numpy()


def _bf16_inputs(inputs):
    """xdt, b_in and c_in rounded to bf16 values (the model path's inputs
    on the card); la stays float32."""
    xdt, la, b_in, c_in = inputs
    r = lambda a: _bf16(torch.from_numpy(a)).numpy()
    return r(xdt), la, r(b_in), r(c_in)


MODEL_SHAPES = [  # (B, S, H, P, N, chunk)
    (1, 256, 2, 64, 128, 256),     # nc = 1, the ssm chunk
    (2, 512, 3, 64, 128, 256),
    (1, 512, 2, 16, 16, 128),
    (2, 128, 4, 32, 64, 16),
    (1, 300, 2, 64, 64, 100),      # a chunk that is not a multiple of 16
    (2, 96, 1, 16, 32, 96),        # nc = 1
    (1, 600, 2, 64, 64, 300),      # cut to 256: a last chunk of 88
    (1, 384, 2, 16, 32, 384),      # cut to 256: a last chunk of 128
]


@pytest.mark.parametrize("f32_inputs", [False, True])
@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_chunk_parallel_model_matches_jax(shape, f32_inputs):
    *dims, chunk = shape
    inputs = _scan_inputs(*dims, seed=sum(shape))
    if not f32_inputs:
        inputs = _bf16_inputs(inputs)
    y, h = _chunk_parallel_model(*inputs, chunk, f32_inputs=f32_inputs)
    ry, rh = jax_ssd_ref(*inputs)
    jy, jh = jax_ssd_scan(*(jnp.asarray(a) for a in inputs), chunk=chunk,
                          interpret=True)
    for ref in (ry, np.asarray(jy)):
        np.testing.assert_allclose(y, ref, **_scale_tol(ref))
    for ref in (rh, np.asarray(jh)):
        np.testing.assert_allclose(h, ref, **_scale_tol(ref))


def _share_of_tol(out, ref):
    tol = _scale_tol(ref)
    return float((np.abs(out - ref) / (tol["atol"] + tol["rtol"]
                                       * np.abs(ref))).max())


@pytest.mark.parametrize("shape", [(1, 256, 2, 64, 128, 256),
                                   (2, 512, 3, 64, 128, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_single_bf16_decayed_g_misses_tolerance(shape):
    """One bf16 rounding of the decayed C B^T tile (2^-9 of each weight)
    puts y more than 10x outside 1e-4 of the largest output; its hi + lo
    split keeps it well inside."""
    *dims, chunk = shape
    inputs = _bf16_inputs(_scan_inputs(*dims, seed=sum(shape)))
    ry, _ = jax_ssd_ref(*inputs)
    split, _ = _chunk_parallel_model(*inputs, chunk)
    single, _ = _chunk_parallel_model(*inputs, chunk, split_g=False)
    assert _share_of_tol(split, ry) < 0.1
    assert _share_of_tol(single, ry) > 10.0
