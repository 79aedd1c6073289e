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
"""

import pytest
import torch

from repro_torch.core import pack_weights, quantize_symmetric
from repro_torch.kernels import _build
from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv
from repro_torch.kernels.bitplane_gemv.ref import bitplane_gemv_ref
from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_prefill_attention,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_prefill_ref,
)

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
