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
version are in ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gemv_engine import quantize_linear as jax_quantize_linear
from repro.kernels.int8_matvec.ops import int8_matvec as jax_int8_matvec
from repro.kernels.int8_matvec.ref import int8_matvec_ref as jax_int8_ref

from repro_torch.core import quantize_linear
from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv
from repro_torch.kernels.int8_matvec import int8_matvec
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
