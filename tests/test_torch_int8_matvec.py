"""PyTorch port vs JAX: the int8 bit-parallel GEMV baseline.

The same int8 codes, scales and activations (numpy, from a seed) go through
JAX ``int8_matvec`` (the Pallas kernel in interpret mode) and
``int8_matvec_ref``, and through the port's ``ops`` wrapper on CPU tensors
(which runs its plain version, ``kernels/int8_matvec/ref.py``) and the plain
version itself: the three shapes of ``tests/test_kernels.py``, a ragged one
(K and N multiples of neither 4 nor 128), a 1-D and a 3-D ``x``, float32 and
bfloat16 activations.  Bit-parallel equals bit-serial at 8 bits in the
port, as in ``tests/test_kernels.py``.

Tolerance in float32: rtol 1e-5, atol 1e-4, as ``tests/test_kernels.py``
holds the Pallas kernel against its oracle.  Every product of an activation
and a code is exact in float32 (a bfloat16 activation converts exactly);
the packages add the products in another order, which moves the last bits
of sums of magnitude up to ~100.

The CUDA kernel itself has no CPU mode: its cases against the plain
version are in ``tests/test_torch_cuda_kernels.py``.  The launcher picks its
design with the bit-plane GEMV's ``route`` (at 8 bits the two share the
tensor-core tile); a prefill-sized ragged case (M = 130, K = 136, N = 200,
bfloat16 x), which that route takes on the card, goes through the ``ops``
wrapper against the Pallas kernel in interpret mode at the tolerance above.
At M <= 8 the launcher runs the bit-plane GEMV's decode design at 8 bits
(``csrc/gemv_decode.cuh``): the int8 codes are byte for byte the 8-bit
packed rows, and the launcher hands the C entry point the balanced grid of
``_gemv.decode_grid`` and counts the launch in
``_build.BALANCED_LAUNCHES`` (checked here with the entry point, the SM
count and the kernel's occupancy replaced, since the kernel cannot run on
the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gemv_engine import quantize_linear as jax_quantize_linear
from repro.kernels.int8_matvec.ops import int8_matvec as jax_int8_matvec
from repro.kernels.int8_matvec.ref import int8_matvec_ref as jax_int8_ref

from repro_torch.core import pack_weights, quantize_linear
from repro_torch.kernels import _gemv
from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv
from repro_torch.kernels.int8_matvec import int8_matvec
from repro_torch.kernels.int8_matvec import kernel as int8_kernel
from repro_torch.kernels.int8_matvec.ref import int8_matvec_ref

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
# tests/test_kernels.py SHAPES[:3], then K and N off every tile multiple
SHAPES = [(1, 64, 48), (3, 300, 130), (8, 1024, 512), (3, 200, 100)]


def _case(lead, k, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal(lead + (k,)).astype(np.float32)
    ql = jax_quantize_linear(jnp.asarray(w), 8)
    return np.array(ql.packed), np.array(ql.scale), x


def _jax(q, scale, x, xdt):
    jx = jnp.asarray(x).astype(xdt)
    y_k = jax_int8_matvec(jnp.asarray(q), jnp.asarray(scale), jx,
                          interpret=True)
    y_r = jax_int8_ref(jnp.asarray(q), jnp.asarray(scale),
                       jx.reshape(-1, x.shape[-1]))
    return np.asarray(y_k), np.asarray(y_r)


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,n", SHAPES)
def test_int8_matvec_matches_jax(b, k, n, xdt):
    q, scale, x = _case((b,), k, n, seed=7 + b + k + n)
    want_k, want_r = _jax(q, scale, x, getattr(jnp, xdt))
    tq, ts = torch.from_numpy(q), torch.from_numpy(scale)
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    got = int8_matvec(tq, ts, tx)
    assert got.shape == (b, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_k, **TOL)
    np.testing.assert_allclose(got.numpy(), want_r, **TOL)
    np.testing.assert_allclose(int8_matvec_ref(tq, ts, tx).numpy(), want_r,
                               **TOL)


@pytest.mark.parametrize("lead", [(), (2, 3)], ids=["1d", "3d"])
def test_int8_matvec_keeps_the_leading_shape(lead):
    """A 1-D ``x`` gives a 1-D result; leading dimensions are flattened and
    restored (JAX ``ops.py:28-33``)."""
    k, n = 200, 100
    q, scale, x = _case(lead, k, n, seed=3)
    want_k, want_r = _jax(q, scale, x, jnp.float32)
    got = int8_matvec(torch.from_numpy(q), torch.from_numpy(scale),
                      torch.from_numpy(x))
    assert got.shape == lead + (n,) == want_k.shape
    np.testing.assert_allclose(got.numpy(), want_k, **TOL)
    np.testing.assert_allclose(got.numpy().reshape(-1, n), want_r, **TOL)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matvec_out_dtype(out_dtype):
    """The float32 sum is cast once to ``out_dtype``, as JAX casts it."""
    q, scale, x = _case((4,), 256, 128, seed=5)
    dt = getattr(torch, out_dtype)
    got = int8_matvec(torch.from_numpy(q), torch.from_numpy(scale),
                      torch.from_numpy(x), out_dtype=dt)
    want = np.asarray(jax_int8_ref(jnp.asarray(q), jnp.asarray(scale),
                                   jnp.asarray(x),
                                   out_dtype=getattr(jnp, out_dtype)))
    assert got.dtype == dt
    tol = TOL if out_dtype == "float32" else dict(rtol=2 ** -7, atol=1e-4)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               **tol)


@pytest.mark.parametrize("b,k,n", [(4, 192, 96), (3, 200, 100)])
def test_bitparallel_equals_bitserial(b, k, n):
    """int8 bit-parallel baseline == bit-serial engine on 8-bit weights, at
    every radix (``tests/test_kernels.py:90-97``)."""
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32))
    ql = quantize_linear(w, 8)
    y_bp = int8_matvec(ql.packed, ql.scale, x)
    for radix in (1, 2, 4, 8):
        y_bs = bitplane_gemv(ql.packed, ql.scale, x, bits=8, radix=radix)
        np.testing.assert_allclose(y_bp.numpy(), y_bs.numpy(), **TOL)


@pytest.mark.parametrize("m,xdt,want", [
    (1, torch.bfloat16, "decode"), (8, torch.float32, "decode"),
    (9, torch.bfloat16, "tensor_core"), (256, torch.bfloat16, "tensor_core"),
    (9, torch.float32, "rows"), (256, torch.float32, "rows")])
def test_int8_route_picks_the_design_by_rows_and_type(m, xdt, want):
    assert int8_kernel.route(m, xdt) == want


def test_prefill_ragged_matches_jax_pallas_interpret():
    """M, K and N of no tile's multiple, bfloat16 x, float32 output."""
    m, k, n = 130, 136, 200
    q, scale, x = _case((m,), k, n, seed=41)
    want_k, want_r = _jax(q, scale, x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    assert int8_kernel.route(m, tx.dtype) == "tensor_core"
    got = int8_matvec(torch.from_numpy(q), torch.from_numpy(scale), tx)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_k, **TOL)
    np.testing.assert_allclose(got.numpy(), want_r, **TOL)


@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 256), (2048, 11008),
                                 (11008, 2048), (2001, 1003)])
def test_int8_codes_are_the_8bit_packed_rows(k, n):
    """The premise of the shared decode route: packing int8 codes at 8 bits
    leaves their bytes as they are."""
    q = torch.from_numpy(_case((1,), k, n, seed=k + n)[0])
    assert torch.equal(pack_weights(q, 8), q)


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 256), (2048, 11008),
                                 (11008, 2048), (2001, 1003)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_decode_launch_takes_the_bitplane_decode_split(monkeypatch, m, k, n,
                                                       xdt):
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(int8_kernel, "_check", lambda *a: None)
    monkeypatch.setattr(int8_kernel, "_entry", entry)
    monkeypatch.setattr(_gemv, "sm_count", lambda dev: 132)
    monkeypatch.setattr(_gemv, "_occupancy", lambda *a: 2)
    monkeypatch.setattr(int8_kernel._build, "BALANCED_LAUNCHES", 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(_gemv, "_SCRATCH", {})
    monkeypatch.setattr(int8_kernel._build, "LAUNCHES",
                        dict(int8_kernel._build.LAUNCHES))
    monkeypatch.setattr(int8_kernel._build, "ROUTE_LAUNCHES",
                        dict(int8_kernel._build.ROUTE_LAUNCHES))
    q = torch.zeros((k, n), dtype=torch.int8)
    scale = torch.ones((1, n))
    x = torch.zeros((m, k), dtype=xdt)
    y = int8_kernel.int8_matvec_cuda(q, scale, x, out_dtype=xdt)
    assert y.shape == (m, n) and y.dtype == xdt
    (name, args), = calls
    assert name == "decode"
    assert args[4] == _gemv._SCRATCH[0, 0].data_ptr()
    assert args[5:9] == (m, k, n, _gemv.decode_grid(k, n, 8, 132, 2))
    assert int8_kernel._build.ROUTE_LAUNCHES["int8_matvec/decode"] == 1
    assert int8_kernel._build.BALANCED_LAUNCHES == 1
