"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each case makes its inputs on the card from a seeded ``torch.Generator``,
runs the kernel through its ``ops`` wrapper, checks that the wrapper counted
one launch, and compares with the plain version (``kernels/*/ref.py``) on
the same tensors.  Every case is marked ``cuda`` and skips on a host
without a CUDA device.  This file imports neither ``jax`` nor ``repro``, so
on a machine with the card and no JAX it runs on its own::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_kernels.py

Tolerances: float32 outputs differ from the plain version only in the
order of float32 sums (rtol 1e-5, atol 1e-5 of the largest output);
bfloat16 outputs by one bf16 ulp (at most 2^-7 of the value); attention
over bf16 / int8 pools also rounds p to bf16 after a softmax whose ``exp``
may differ in its last bit, so two bf16 ulps of values near 1 (2^-6).
Flash attention keeps p in float32 and takes its online softmax in 64-key
steps where the plain version takes one softmax over the row: float32
outputs within 1e-5, bfloat16 outputs within one bf16 ulp of the value
plus 1e-5 (the sums differ in their last float32 bits before the one
rounding).  The SSD scan is chunked float32 arithmetic against the plain
float64 recurrence: within 1e-4 of the largest output (cumulative decays
summed in float32 over a chunk, exponentials of float32 arguments).
The int8 bit-parallel GEMV adds K products in float32 in another order than
the plain version: within 16·√K·2^-24 of Σ|x|·|q|·scale per element (one
bf16 ulp more for bfloat16 outputs).  The engine's exact case feeds integer
weights and activations whose partial sums stay below 2^24, so the tile
model and every kernel must equal ``w @ x`` exactly.
"""

import math

import numpy as np

import pytest
import torch

from repro_torch.core import (
    QuantizedLinear,
    gemv,
    pack_weights,
    quantize_symmetric,
)
from repro_torch.core.controller import run_gemv
from repro_torch.core.isa import MAX_ELEMS
from repro_torch.kernels import _build
from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv
from repro_torch.kernels.bitplane_gemv.ref import bitplane_gemv_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.int8_matvec.ops import int8_matvec
from repro_torch.kernels.int8_matvec.ref import int8_matvec_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_prefill_attention,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_prefill_ref,
)
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

CASES = [(bits, radix) for bits in (2, 4, 8) for radix in (1, 2, 4)
         if bits % radix == 0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    # the plain versions' float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 72, 33), (7, 520, 300),
                                   (40, 2048, 256), (3, 11008, 96)])
@pytest.mark.parametrize("bits,radix", CASES)
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_gemv_matches_plain(cuda_device, bits, radix, m, k, n, xdt):
    """Any M, and K and N that are not tile multiples."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n + bits)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, bits)
    packed = pack_weights(q, bits)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    before = _build.LAUNCHES["bitplane_gemv"]
    y = bitplane_gemv(packed, scale, x, bits=bits, radix=radix, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bitplane_gemv"] == before + 1
    r = bitplane_gemv_ref(packed, scale, x, bits=bits, radix=radix,
                          out_dtype=dt)
    assert y.shape == (m, n) and y.dtype == dt
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol,
                               atol=1e-5 * r.float().abs().max().item())


def _pools(gen, kind, n_pages, page, hkv, dh, dev):
    if kind == "int8":
        kp = torch.randint(-127, 128, (n_pages, page, hkv, dh), generator=gen,
                           device=dev).to(torch.int8)
        vp = torch.randint(-127, 128, (n_pages, page, hkv, dh), generator=gen,
                           device=dev).to(torch.int8)
        ks = (0.004 + 0.016 * torch.rand((n_pages, page, hkv), generator=gen,
                                         device=dev)).bfloat16()
        vs = (0.004 + 0.016 * torch.rand((n_pages, page, hkv), generator=gen,
                                         device=dev)).bfloat16()
        return kp, vp, ks, vs
    dt = getattr(torch, kind)
    kp = torch.randn((n_pages, page, hkv, dh), generator=gen, device=dev)
    vp = torch.randn((n_pages, page, hkv, dh), generator=gen, device=dev)
    return kp.to(dt), vp.to(dt), None, None


def _attn_tol(kind):
    return (dict(rtol=1e-5, atol=1e-5) if kind == "float32"
            else dict(rtol=2 ** -6, atol=2 ** -6))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [0, 37])
def test_decode_attention_matches_plain(cuda_device, kind, window):
    """Ragged last blocks, a lane at position 0 and one at the last slot."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, hkv, g, dh, page, nblk = 5, 2, 8, 128, 16, 9
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                    device=cuda_device).to(qdt)
    pos = torch.tensor([0, 15, 16, 77, page * nblk - 1], dtype=torch.int32,
                       device=cuda_device)
    before = _build.LAUNCHES["paged_decode_attention"]
    y = paged_attention(q, kp, vp, bt, pos, window, ks, vs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_decode_attention"] == before + 1
    r = paged_attention_ref(q, kp, vp, bt, pos, window, ks, vs)
    assert y.shape == r.shape and y.dtype == qdt
    torch.testing.assert_close(y.float(), r.float(), **_attn_tol(kind))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [0, 37])
def test_prefill_attention_matches_plain(cuda_device, kind, window):
    """Mid-page ``pos0``, a ragged last lane and an idle lane
    (``seq_lens == pos0``, whose rows attend no key and are discarded)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    b, hkv, g, dh, page, nblk, c = 4, 2, 8, 128, 16, 12, 32
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn((b, c, hkv * g, dh), generator=gen,
                    device=cuda_device).to(qdt)
    pos0 = torch.tensor([0, 19, 100, 40], dtype=torch.int32,
                        device=cuda_device)
    seq = pos0 + c
    seq[2] -= 7
    seq[3] = pos0[3]
    before = _build.LAUNCHES["paged_prefill_attention"]
    y = paged_prefill_attention(q, kp, vp, bt, pos0, seq, window, ks, vs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_prefill_attention"] == before + 1
    r = paged_prefill_ref(q, kp, vp, bt, pos0, seq, window, ks, vs)
    torch.testing.assert_close(y[:3].float(), r[:3].float(),
                               **_attn_tol(kind))
    assert bool(torch.isfinite(y[3]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("s,hq,hkv,d,window", [
    (256, 8, 1, 128, 0), (200, 4, 4, 64, 0), (333, 8, 2, 32, 64),
    (4100, 16, 2, 128, 0), (1030, 16, 2, 128, 1024), (64, 2, 1, 128, 1)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_flash_attention_matches_plain(cuda_device, s, hq, hkv, d, window,
                                       xdt):
    """Ragged S (no padded copy), GQA groups 1-8, head dims 32-128, windows
    of 1 key up to 1024, and the sequence longer than the window."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(s + hq + d)
    q = torch.randn((2, s, hq, d), generator=gen, device=cuda_device).to(dt)
    k = torch.randn((2, s, hkv, d), generator=gen, device=cuda_device).to(dt)
    v = torch.randn((2, s, hkv, d), generator=gen, device=cuda_device).to(dt)
    before = _build.LAUNCHES["flash_attention"]
    y = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    r = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), window=window).transpose(1, 2)
    assert y.shape == q.shape and y.dtype == dt
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,s,nh,n,chunk", [
    (2, 512, 3, 128, 256), (1, 384, 2, 64, 128), (2, 256, 2, 128, 64),
    (1, 96, 1, 128, 32), (1, 300, 2, 64, 100)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_ssd_scan_matches_plain(cuda_device, bsz, s, nh, n, chunk, xdt):
    """Chunks of 256 down to 32 steps, a chunk that is not a multiple of the
    kernel's 64-step tile, both state sizes the kernel takes."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(s + nh + n)
    xdt_in = (0.1 * torch.randn((bsz, s, nh, 64), generator=gen,
                                device=cuda_device)).to(dt)
    la = -0.2 * torch.rand((bsz, s, nh), generator=gen, device=cuda_device)
    b_in = torch.randn((bsz, s, n), generator=gen, device=cuda_device).to(dt)
    c_in = torch.randn((bsz, s, n), generator=gen, device=cuda_device).to(dt)
    before = _build.LAUNCHES["ssd_scan"]
    y, h = ssd_scan(xdt_in, la, b_in, c_in, chunk=chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_scan"] == before + 1
    ry, rh = ssd_scan_ref(xdt_in, la, b_in, c_in, chunk)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (bsz, s, nh, 64) and h.shape == (bsz, nh, 64, n)
    for out, ref in ((y, ry), (h, rh)):
        torch.testing.assert_close(out, ref, rtol=1e-4,
                                   atol=1e-4 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 72, 33), (3, 200, 100), (8, 2048, 256),
                                   (9, 520, 300), (40, 2001, 1003),
                                   (256, 2048, 2048)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_int8_matvec_matches_plain(cuda_device, m, k, n, xdt):
    """Both block shapes (M <= 8 and more rows), several K tiles, and K and
    N that are multiples of neither 4 nor 128 (byte loads, masked edges)."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, 8)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    before = _build.LAUNCHES["int8_matvec"]
    y = int8_matvec(q, scale, x, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["int8_matvec"] == before + 1
    r = int8_matvec_ref(q, scale, x, out_dtype=dt)
    assert y.shape == (m, n) and y.dtype == dt
    s = (x.float().abs() @ q.float().abs()) * scale
    atol = 2.0 ** -20 * math.sqrt(k) * s
    rtol = 0.0 if dt == torch.float32 else 2 ** -7
    err = (y.float() - r.float()).abs()
    assert bool((err <= atol + rtol * r.float().abs()).all()), float(
        err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [200, 1000])
def test_engine_exact_integer_gemv(cuda_device, d):
    """The tile model, the bit-plane GEMV at radix 1 and 2 and the int8
    kernel all equal ``w @ x`` on integer weights and activations."""
    rng = np.random.default_rng(d)
    r_max = (2 ** 24 - 1) // (d * 127)
    w = rng.integers(-127, 128, size=(d, d))
    x = rng.integers(-r_max, r_max + 1, size=(d,))
    want = (w @ x).astype(np.float64)
    res = run_gemv(w, x, rows=16, cols=-(-d // MAX_ELEMS))
    np.testing.assert_array_equal(res.y, w @ x)
    codes = torch.as_tensor(np.ascontiguousarray(w.T), dtype=torch.int8,
                            device=cuda_device)
    ql = QuantizedLinear(pack_weights(codes, 8),
                         torch.ones((1, d), device=cuda_device), 8, d, d)
    xt = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    before = dict(_build.LAUNCHES)
    outs = [gemv(ql, xt, radix=1), gemv(ql, xt, radix=2),
            int8_matvec(ql.packed, ql.scale, xt)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bitplane_gemv"] == before["bitplane_gemv"] + 2
    assert _build.LAUNCHES["int8_matvec"] == before["int8_matvec"] + 1
    for y in outs:
        np.testing.assert_array_equal(y.double().cpu().numpy(), want)
