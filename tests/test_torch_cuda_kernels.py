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
Flash attention keeps p in float32 (on the tensor cores, for bfloat16
inputs, as bf16 hi + lo) and takes its online softmax in 64-key steps
where the plain version takes one softmax over the row: float32 outputs
within 1e-5, bfloat16 outputs within one bf16 ulp of the value plus 1e-5
(the sums differ in their last float32 bits before the one rounding).
Flash attention and the chunked prefill pick a design by dtype
(``tensor_core`` for bfloat16, ``cuda_core`` for float32): their cases
check that the route's counter moved.  The SSD scan is chunked float32 arithmetic against the plain
float64 recurrence: within 1e-4 of the largest output (cumulative decays
summed in float32 over a chunk, exponentials of float32 arguments, float32
operands of its tensor-core products split into bf16 hi + lo); its three
passes reduce in a fixed order, so two calls give the same bits.
The int8 bit-parallel GEMV adds K products in float32 in another order than
the plain version: within 16·√K·2^-24 of Σ|x|·|q|·scale per element (one
bf16 ulp more for bfloat16 outputs).  Both GEMVs pick a design by M and the
type of x (``route``): every GEMV case also checks that its route's counter
moved, and the bfloat16 cases at M > 8 (9, 130, 8192; K = 200 and 520,
neither a multiple of the tile's K step; N = 300 and 1983, neither 16- nor
8-byte aligned, and 3352, only 8-byte aligned) take the tensor-core tile.  The engine's exact case feeds integer
weights and activations whose partial sums stay below 2^24, so the tile
model and every kernel must equal ``w @ x`` exactly.  The decode-step
kernels (paged decode attention split over the keys, the GEMVs' decode
route split over K, shared by the int8 baseline at 8 bits) reduce their
splits in a fixed order: their cases also run each call twice and require
the same bits.  Flash attention and the
paged prefill take head dims outside 32 / 64 / 128 through the launcher's
zero padding (D = 16 and 112 here).

The serving steps as CUDA graphs (``-k graph``): ``decode_step_paged``,
``prefill_chunk`` and the full-sequence ``decode_step`` (dense and ssm),
each captured by ``serve.StepGraph`` on reduced configs cut to 2 layers
(bf16, 4-bit weights), replayed over several steps with new inputs and
held against eager calls of the same function on a copy of the same
state: the same kernels on the same inputs, so logits and caches must be
bit-identical, and each replay must add the launches, by kernel and by
route, that an eager step counts.  ``ServeEngine`` with graphs gives the
same greedy tokens as with ``cuda_graphs=False``, in both modes.
"""

import dataclasses
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
from repro_torch.config import EngineConfig, ServeConfig, get_reduced
from repro_torch.core.controller import run_gemv
from repro_torch.engine import resolve_plan
from repro_torch.core.isa import MAX_ELEMS
from repro_torch.kernels import _build
from repro_torch.kernels._gemv import route
from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv
from repro_torch.kernels.bitplane_gemv.ref import bitplane_gemv_ref
from repro_torch.kernels.flash_attention.kernel import (
    route as flash_route,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.int8_matvec.ops import int8_matvec
from repro_torch.kernels.int8_matvec.ref import int8_matvec_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.kernel import prefill_route
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
from repro_torch.models import (
    decode_step,
    decode_step_paged,
    init_cache,
    init_params,
    prefill_chunk,
)
from repro_torch.serve import LaneTables, ServeEngine, StepGraph, init_kv_pages

CASES = [(bits, radix) for bits in (2, 4, 8) for radix in (1, 2, 4, 8)
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
                                   (40, 2048, 256), (3, 11008, 96),
                                   (9, 200, 300), (130, 520, 1983),
                                   (8192, 200, 3352)])
@pytest.mark.parametrize("bits,radix", CASES)
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_gemv_matches_plain(cuda_device, bits, radix, m, k, n, xdt):
    """Any M, and K and N that are not tile multiples, through each route."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n + bits)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, bits)
    packed = pack_weights(q, bits)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    path = f"bitplane_gemv/{route(m, dt)}"
    before = _build.LAUNCHES["bitplane_gemv"]
    before_route = _build.ROUTE_LAUNCHES[path]
    y = bitplane_gemv(packed, scale, x, bits=bits, radix=radix, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bitplane_gemv"] == before + 1
    assert _build.ROUTE_LAUNCHES[path] == before_route + 1
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


# (K, N) of the decode GEMV cases: qwen2.5-3b's four linears, and K and N
# ragged (K a multiple of the codes a byte holds, of no 16-deep K step)
DECODE_SHAPES = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048),
                 "ragged"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("bits,radix", [(2, 1), (2, 2), (4, 1), (4, 2),
                                        (8, 1), (8, 2)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_gemv_decode_route(cuda_device, xdt, bits, radix, m, shape):
    """The decode route at the decode steps' M (8 paged, 2 and 4 on the
    full-sequence paths, 1 on the engine path): one launch of that route,
    within the tolerance of the plain version, the same bits twice."""
    dt = getattr(torch, xdt)
    k, n = shape if shape != "ragged" else (2001 + (-2001) % (8 // bits),
                                            1003)
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n + bits)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, bits)
    packed = pack_weights(q, bits)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    assert route(m, dt) == "decode"
    before = _build.ROUTE_LAUNCHES["bitplane_gemv/decode"]
    y = bitplane_gemv(packed, scale, x, bits=bits, radix=radix, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES["bitplane_gemv/decode"] == before + 1
    again = bitplane_gemv(packed, scale, x, bits=bits, radix=radix,
                          out_dtype=dt)
    assert torch.equal(y, again)
    r = bitplane_gemv_ref(packed, scale, x, bits=bits, radix=radix,
                          out_dtype=dt)
    assert y.shape == (m, n) and y.dtype == dt
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol,
                               atol=1e-5 * r.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("g", [1, 5, 8, 12])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_decode_attention_splits(cuda_device, kind, g, dh, page):
    """A table of 4096 keys (64 splits), lanes at position 0 (one split
    attended), mid-context and at the last slot; G of 1-12 query heads a KV
    head (one and two passes of 8); one launch, the same bits twice."""
    gen = torch.Generator(device=cuda_device).manual_seed(g + dh + page)
    b, hkv = 4, 2
    nblk = 4096 // page
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                    device=cuda_device).to(qdt)
    pos = torch.tensor([0, 1000, 2222, 4095], dtype=torch.int32,
                       device=cuda_device)
    before = _build.LAUNCHES["paged_decode_attention"]
    y = paged_attention(q, kp, vp, bt, pos, 0, ks, vs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_decode_attention"] == before + 1
    assert torch.equal(y, paged_attention(q, kp, vp, bt, pos, 0, ks, vs))
    r = paged_attention_ref(q, kp, vp, bt, pos, 0, ks, vs)
    assert y.shape == r.shape and y.dtype == qdt
    torch.testing.assert_close(y.float(), r.float(), **_attn_tol(kind))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("g,start", [(8, 0), (1, 0), (4, 0), (8, 260)])
def test_prefill_attention_matches_plain(cuda_device, kind, window, g,
                                         start):
    """Mid-page ``pos0``, a ragged last lane and an idle lane
    (``seq_lens == pos0``, whose rows attend no key and are discarded);
    G of 8, 1 and 4 query heads a KV head; contexts past 256 tokens (several
    steps of the page walk) when ``start`` moves every ``pos0`` on."""
    gen = torch.Generator(device=cuda_device).manual_seed(
        1 + start + 10 * (8 - g))
    b, hkv, dh, page, c = 4, 2, 128, 16, 32
    nblk = 12 + -(-start // page)
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn((b, c, hkv * g, dh), generator=gen,
                    device=cuda_device).to(qdt)
    pos0 = start + torch.tensor([0, 19, 100, 40], dtype=torch.int32,
                                device=cuda_device)
    seq = pos0 + c
    seq[2] -= 7
    seq[3] = pos0[3]
    path = ("paged_prefill_attention/"
            f"{prefill_route(qdt, kp.dtype, dh, g)}")
    before = _build.LAUNCHES["paged_prefill_attention"]
    before_route = _build.ROUTE_LAUNCHES[path]
    y = paged_prefill_attention(q, kp, vp, bt, pos0, seq, window, ks, vs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_prefill_attention"] == before + 1
    assert _build.ROUTE_LAUNCHES[path] == before_route + 1
    assert path.endswith("cuda_core" if kind == "float32" else "tensor_core")
    r = paged_prefill_ref(q, kp, vp, bt, pos0, seq, window, ks, vs)
    torch.testing.assert_close(y[:3].float(), r[:3].float(),
                               **_attn_tol(kind))
    assert bool(torch.isfinite(y[3]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("dh", [16, 112])
def test_prefill_attention_pads_head_dim(cuda_device, kind, dh):
    """Head dims outside the tensor-core tiles' widths: q and the pools
    zero-padded by the launcher, the same route, one launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(dh)
    b, hkv, g, page, c, nblk = 3, 2, 8, 16, 32, 12
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    q = torch.randn((b, c, hkv * g, dh), generator=gen,
                    device=cuda_device).bfloat16()
    pos0 = torch.tensor([0, 45, 150], dtype=torch.int32, device=cuda_device)
    seq = pos0 + c
    before = _build.ROUTE_LAUNCHES["paged_prefill_attention/tensor_core"]
    y = paged_prefill_attention(q, kp, vp, bt, pos0, seq, 0, ks, vs)
    torch.cuda.synchronize()
    assert (_build.ROUTE_LAUNCHES["paged_prefill_attention/tensor_core"]
            == before + 1)
    r = paged_prefill_ref(q, kp, vp, bt, pos0, seq, 0, ks, vs)
    assert y.shape == r.shape
    torch.testing.assert_close(y.float(), r.float(), **_attn_tol(kind))


@pytest.mark.cuda
@pytest.mark.parametrize("s,hq,hkv,d,window", [
    (256, 8, 1, 128, 0), (200, 4, 4, 64, 0), (333, 8, 2, 32, 64),
    (4100, 16, 2, 128, 0), (1030, 16, 2, 128, 1024), (64, 2, 1, 128, 1),
    (300, 4, 2, 16, 0), (1100, 8, 2, 112, 0), (777, 4, 4, 112, 64)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_flash_attention_matches_plain(cuda_device, s, hq, hkv, d, window,
                                       xdt):
    """Ragged S (no padded copy), GQA groups 1-8, head dims 32-128 and
    the zero-padded 16 and 112, windows of 1 key up to 1024, and the
    sequence longer than the window."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(s + hq + d)
    q = torch.randn((2, s, hq, d), generator=gen, device=cuda_device).to(dt)
    k = torch.randn((2, s, hkv, d), generator=gen, device=cuda_device).to(dt)
    v = torch.randn((2, s, hkv, d), generator=gen, device=cuda_device).to(dt)
    path = f"flash_attention/{flash_route(dt, d)}"
    before = _build.LAUNCHES["flash_attention"]
    before_route = _build.ROUTE_LAUNCHES[path]
    y = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert _build.ROUTE_LAUNCHES[path] == before_route + 1
    assert path.endswith("cuda_core" if xdt == "float32" else "tensor_core")
    r = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), window=window).transpose(1, 2)
    assert y.shape == q.shape and y.dtype == dt
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,s,nh,n,chunk", [
    (2, 512, 3, 128, 256), (1, 384, 2, 64, 128), (2, 256, 2, 128, 64),
    (1, 96, 1, 128, 32), (1, 300, 2, 64, 100),
    (1, 256, 24, 128, 256), (2, 256, 24, 64, 256), (1, 4096, 8, 128, 256),
    (2, 4096, 24, 64, 256), (1, 4096, 4, 128, 128), (2, 2048, 24, 64, 64),
    (1, 600, 2, 64, 300), (2, 768, 3, 128, 384)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_ssd_scan_matches_plain(cuda_device, bsz, s, nh, n, chunk, xdt):
    """Chunks of 256 down to 32 steps, a chunk that is not a multiple of
    16, chunks over 256 steps that the kernels cut to 256 (600 steps end
    in a shorter chunk of 88), both state sizes the kernel takes (64:
    zamba2's, 128: mamba2's), 1, 16 and 32 chunks, grids from a few blocks
    to several waves of the card; the same bits from two calls."""
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
    again = ssd_scan(xdt_in, la, b_in, c_in, chunk=chunk)
    assert torch.equal(y, again[0]) and torch.equal(h, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 72, 33), (3, 200, 100), (8, 2048, 256),
                                   (9, 520, 300), (40, 2001, 1003),
                                   (256, 2048, 2048), (130, 200, 1983),
                                   (8192, 520, 3352)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_int8_matvec_matches_plain(cuda_device, m, k, n, xdt):
    """Every route (M <= 8, and more rows with float32 or bfloat16 x),
    several K tiles, and K and N that are multiples of neither 4 nor 128
    (byte loads, masked edges), or N only 8-byte aligned."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, 8)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    path = f"int8_matvec/{route(m, dt)}"
    before = _build.LAUNCHES["int8_matvec"]
    before_route = _build.ROUTE_LAUNCHES[path]
    y = int8_matvec(q, scale, x, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["int8_matvec"] == before + 1
    assert _build.ROUTE_LAUNCHES[path] == before_route + 1
    r = int8_matvec_ref(q, scale, x, out_dtype=dt)
    assert y.shape == (m, n) and y.dtype == dt
    s = (x.float().abs() @ q.float().abs()) * scale
    atol = 2.0 ** -20 * math.sqrt(k) * s
    rtol = 0.0 if dt == torch.float32 else 2 ** -7
    err = (y.float() - r.float()).abs()
    assert bool((err <= atol + rtol * r.float().abs()).all()), float(
        err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_int8_matvec_decode_route(cuda_device, monkeypatch, xdt, m, shape):
    """The int8 baseline's decode route is the bit-plane GEMV's decode
    design at 8 bits: one launch of that route with ``decode_splits``'
    split count for the shape and the card, within the int8 tolerance of
    the plain version, the same bits twice."""
    from repro_torch.kernels import _gemv
    from repro_torch.kernels.int8_matvec import kernel as int8_kernel

    splits_seen, entry_args = [], []
    real_splits, real_entry = int8_kernel.decode_splits, int8_kernel._entry

    def spy_splits(k, n, sms):
        splits_seen.append(real_splits(k, n, sms))
        return splits_seen[-1]

    def spy_entry(name):
        fn = real_entry(name)

        def call(*args):
            entry_args.append((name, args))
            return fn(*args)
        return call

    monkeypatch.setattr(int8_kernel, "decode_splits", spy_splits)
    monkeypatch.setattr(int8_kernel, "_entry", spy_entry)
    dt = getattr(torch, xdt)
    k, n = shape if shape != "ragged" else (2001, 1003)
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, 8)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    assert route(m, dt) == "decode"
    before = _build.ROUTE_LAUNCHES["int8_matvec/decode"]
    y = int8_matvec(q, scale, x, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES["int8_matvec/decode"] == before + 1
    want = _gemv.decode_splits(k, n, _gemv.sm_count(cuda_device))
    assert splits_seen == [want]
    (name, args), = entry_args
    assert name == "decode" and args[4:8] == (m, k, n, want)
    again = int8_matvec(q, scale, x, out_dtype=dt)
    assert torch.equal(y, again)
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


# ------------------------------------------------- serving steps as graphs
GRAPH_STEPS = 5        # the eager first call, the capture's replay, three


def _graph_model(arch, dev, kv_bits=0):
    cfg = dataclasses.replace(get_reduced(arch), n_layers=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         engine_bits=4)
    plan = resolve_plan(EngineConfig(weight_bits=4, kv_bits=kv_bits),
                        device=dev)
    return cfg, params, plan


def _launch_counts():
    return {**_build.LAUNCHES, **_build.ROUTE_LAUNCHES}


def _moved(before):
    return {k: v - before[k] for k, v in _launch_counts().items()
            if v != before[k]}


def _random_pool(pages, gen):
    for t in (pages.k, pages.v):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=t.device, dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device))
    for t in (pages.k_scale, pages.v_scale):
        if t is not None:
            t.copy_(torch.rand(t.shape, generator=gen, device=t.device)
                    / 64 + 1e-3)


def _clone_pages(pages):
    return dataclasses.replace(
        pages, **{name: None if getattr(pages, name) is None
                  else getattr(pages, name).clone()
                  for name in ("k", "v", "k_scale", "v_scale")})


def _same_pages(a, b):
    """Equal pools but for the null page 0, where idle lanes and chunk
    padding write in no fixed order and nothing reads."""
    return all((getattr(a, n) is None and getattr(b, n) is None)
               or torch.equal(getattr(a, n)[:, 1:], getattr(b, n)[:, 1:])
               for n in ("k", "v", "k_scale", "v_scale"))


def _replay_against_eager(graph, eager, load, check_state):
    """Each step: ``load(step)`` fills the graph's lane buffers and
    returns the eager call's inputs; the graph's output (a copy: the next
    replay overwrites it) and launch counts must equal the eager call's."""
    for step in range(GRAPH_STEPS):
        inputs = load(step)
        before = _launch_counts()
        out_g = graph().clone()
        torch.cuda.synchronize()
        moved_g = _moved(before)
        before = _launch_counts()
        out_e = eager(*inputs)
        torch.cuda.synchronize()
        moved_e = _moved(before)
        assert moved_g == moved_e and moved_e, (step, moved_g, moved_e)
        assert torch.equal(out_g, out_e), step
        assert torch.isfinite(out_e.float()).all()
        check_state(step)
    assert graph.graph is not None and graph.calls == GRAPH_STEPS


def _paged_inputs(rng, b, nblk, page, span):
    """Block tables and positions with pages mapped for ``span`` tokens
    from each lane's position on (lane i owns pages 1 + i * nblk ...)."""
    bt = np.zeros((b, nblk), np.int32)
    pos = rng.integers(0, nblk * page - span, b).astype(np.int32)
    for lane in range(b):
        used = -(-(int(pos[lane]) + span) // page)
        bt[lane, :used] = 1 + lane * nblk + np.arange(used)
    return bt, pos


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_graph_paged_decode_matches_eager(cuda_device, kv_bits):
    cfg, params, plan = _graph_model("qwen2.5-3b", cuda_device, kv_bits)
    b, nblk, page = 4, 6, 16
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    pages_g = init_kv_pages(cfg, b * nblk + 1, page, kv_bits=kv_bits,
                            device=cuda_device)
    _random_pool(pages_g, gen)
    pages_e = _clone_pages(pages_g)
    lanes = LaneTables(b, cuda_device, max_blocks=nblk)
    graph = StepGraph(lambda: decode_step_paged(
        params, pages_g, lanes.block_tables, lanes.pos, lanes.active,
        lanes.tokens, cfg, plan))
    rng = np.random.default_rng(kv_bits)

    def load(step):
        bt, pos = _paged_inputs(rng, b, nblk, page, 1)
        active = rng.integers(0, 2, b).astype(bool)
        active[step % b] = True
        tokens = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        lanes.load(block_tables=bt, pos=pos, active=active, tokens=tokens)
        return [torch.from_numpy(a).to(cuda_device)
                for a in (bt, pos, active, tokens)]

    _replay_against_eager(
        graph, lambda bt, pos, active, tokens: decode_step_paged(
            params, pages_e, bt, pos, active, tokens, cfg, plan),
        load, lambda step: _same_pages(pages_g, pages_e) or pytest.fail(
            f"pools differ after step {step}"))
    assert graph.launches["bitplane_gemv/decode"] == 7 * cfg.n_layers
    assert graph.launches["paged_decode_attention"] == cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_graph_prefill_chunk_matches_eager(cuda_device, kv_bits):
    cfg, params, plan = _graph_model("qwen2.5-3b", cuda_device, kv_bits)
    b, nblk, page, chunk = 4, 6, 16, 16
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    pages_g = init_kv_pages(cfg, b * nblk + 1, page, kv_bits=kv_bits,
                            device=cuda_device)
    _random_pool(pages_g, gen)
    pages_e = _clone_pages(pages_g)
    lanes = LaneTables(b, cuda_device, max_blocks=nblk, chunk=chunk)
    graph = StepGraph(lambda: prefill_chunk(
        params, pages_g, lanes.block_tables, lanes.chunk_tokens,
        lanes.pos0, lanes.seq_lens, cfg, plan))
    rng = np.random.default_rng(10 + kv_bits)

    def load(step):
        bt, pos0 = _paged_inputs(rng, b, nblk, page, chunk)
        seq_lens = pos0 + rng.integers(0, chunk + 1, b).astype(np.int32)
        seq_lens[step % b] = pos0[step % b] + 1
        tokens = rng.integers(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
        lanes.load(block_tables=bt, chunk_tokens=tokens, pos0=pos0,
                   seq_lens=seq_lens)
        return [torch.from_numpy(a).to(cuda_device)
                for a in (bt, tokens, pos0, seq_lens)]

    _replay_against_eager(
        graph, lambda bt, tokens, pos0, seq_lens: prefill_chunk(
            params, pages_e, bt, tokens, pos0, seq_lens, cfg, plan),
        load, lambda step: _same_pages(pages_g, pages_e) or pytest.fail(
            f"pools differ after step {step}"))
    assert graph.launches["bitplane_gemv/tensor_core"] == 7 * cfg.n_layers
    assert (graph.launches["paged_prefill_attention/tensor_core"]
            == cfg.n_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_graph_decode_step_matches_eager(cuda_device, arch):
    cfg, params, plan = _graph_model(arch, cuda_device)
    b, max_len = 4, 64
    cache_g = init_cache(cfg, b, max_len, device=cuda_device)
    cache_e = {k: v.clone() for k, v in cache_g.items()}
    lanes = LaneTables(b, cuda_device)
    graph = StepGraph(lambda: decode_step(
        params, cache_g, lanes.tokens, cfg, plan, active=lanes.active)[0])
    rng = np.random.default_rng(3)

    def load(step):
        active = rng.integers(0, 2, b).astype(bool)
        active[step % b] = True
        tokens = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        lanes.load(active=active, tokens=tokens)
        return [torch.from_numpy(a).to(cuda_device)
                for a in (tokens, active)]

    def same_cache(step):
        for name in cache_g:
            assert torch.equal(cache_g[name], cache_e[name]), (step, name)

    _replay_against_eager(
        graph, lambda tokens, active: decode_step(
            params, cache_e, tokens, cfg, plan, active=active)[0],
        load, same_cache)
    assert int(cache_g["pos"].sum()) > 0
    assert graph.launches["bitplane_gemv/decode"] == (
        (7 if cfg.family == "dense" else 2) * cfg.n_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode", [("qwen2.5-3b", "paged"),
                                       ("qwen2.5-3b", "slots"),
                                       ("mamba2-130m", "slots")])
def test_graph_engine_tokens_match_eager(cuda_device, arch, mode):
    cfg, params, _ = _graph_model(arch, cuda_device)
    kv_bits = 8 if mode == "paged" else 0
    scfg = ServeConfig(max_new_tokens=6, page_size=4, prefill_chunk=5,
                       engine=EngineConfig(weight_bits=4, kv_bits=kv_bits))
    prompts = [list(range(1 + i, 4 + 3 * i)) for i in range(5)]
    out = {}
    for graphs in (True, False):
        eng = ServeEngine(cfg, params, scfg, n_slots=3, max_len=48,
                          mode=mode, cuda_graphs=graphs, device=cuda_device)
        before = _launch_counts()
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        assert eng.cuda_graphs is graphs
        out[graphs] = ([r.output for r in reqs], _moved(before))
        if graphs:
            assert all(g.graph is not None for g in eng._graphs)
            assert len(eng.timings["capture"]) == len(eng._graphs)
    assert out[True][0] == out[False][0]
    assert all(len(o) == 6 for o in out[True][0])
    # the replays counted every launch the eager engine counted
    assert out[True][1] == out[False][1]
