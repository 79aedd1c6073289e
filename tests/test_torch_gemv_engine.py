"""PyTorch port vs JAX: the legacy engine surface (``core/gemv_engine.py``).

The same float weights and activations (numpy, from a seed) go through
JAX's ``quantize_linear`` / ``gemv`` / ``gemv_reference`` /
``gemv_bit_serial_reference`` / ``engine_dense`` and through the port's:

* ``quantize_linear`` gives the same bytes (codes and scales) at b in
  {8, 4, 2}, whatever the strides of the weight;
* the two oracles (radix 1, 2, 4 where they divide b), ``gemv`` (``auto``
  on CPU tensors resolves to ``reference``; ``bit_serial`` by name) and
  ``engine_dense`` (engine off and on) agree with JAX's;
* ``as_packed`` takes the port's ``QuantizedLinear``, as JAX's takes its
  own (``tests/test_engine_plan.py:224-260``).

Tolerance in float32: rtol = atol = 1e-5 (sums of exact products added in
another order; magnitudes ~10).  The dense product of ``engine_dense`` with
the engine off: rtol 1e-5, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gemv_engine as jge
from repro.engine import EnginePlan as JaxEnginePlan
from repro.engine import as_packed as jax_as_packed

from repro_torch.core import QuantizedLinear, gemv, quantize_linear
from repro_torch.core import gemv_engine as tge
from repro_torch.engine import EnginePlan, PackedLinear, as_packed

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BITS_RADIX = [(b, r) for b in (8, 4, 2) for r in (1, 2, 4) if b % r == 0]


def _data(lead, k, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal(lead + (k,)).astype(np.float32)
    return w, x


def _port(jql):
    return QuantizedLinear(torch.from_numpy(np.array(jql.packed)),
                           torch.from_numpy(np.array(jql.scale)), jql.bits,
                           jql.in_features, jql.out_features)


@pytest.mark.parametrize("transposed", [False, True],
                         ids=["contiguous", "transposed-view"])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quantize_linear_bytes_equal_jax(bits, transposed):
    w, _ = _data((1,), 64, 24, seed=bits)
    src = np.ascontiguousarray(w.T).T if transposed else w
    jql = jge.quantize_linear(jnp.asarray(w), bits)
    ql = quantize_linear(torch.from_numpy(src), bits)
    assert isinstance(ql, QuantizedLinear)
    assert (ql.bits, ql.in_features, ql.out_features) == (bits, 64, 24)
    assert ql.packed.dtype == torch.int8 and ql.packed.is_contiguous()
    np.testing.assert_array_equal(ql.packed.numpy(), np.asarray(jql.packed))
    np.testing.assert_array_equal(ql.scale.numpy(), np.asarray(jql.scale))
    np.testing.assert_array_equal(
        tge.dequantize_linear(ql).numpy(),
        np.asarray(jge.dequantize_linear(jql)))


@pytest.mark.parametrize("lead", [(1,), (3,), (2, 5)])
@pytest.mark.parametrize("bits,radix", BITS_RADIX)
def test_oracles_and_gemv_match_jax(bits, radix, lead):
    w, x = _data(lead, 72, 33, seed=bits * 10 + radix + sum(lead))
    jql = jge.quantize_linear(jnp.asarray(w), bits)
    ql = _port(jql)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want_ref = np.asarray(jge.gemv_reference(jql, jx))
    want_bs = np.asarray(jge.gemv_bit_serial_reference(jql, jx, radix=radix))
    np.testing.assert_allclose(tge.gemv_reference(ql, tx).numpy(), want_ref,
                               **TOL)
    np.testing.assert_allclose(
        tge.gemv_bit_serial_reference(ql, tx, radix=radix).numpy(), want_bs,
        **TOL)
    # gemv: auto on CPU tensors is the reference backend; the bit-serial
    # backend by name; JAX's shim with the Pallas kernel in interpret mode
    y = gemv(ql, tx, radix=radix)
    assert y.shape == lead + (33,) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jge.gemv(jql, jx)),
                               **TOL)
    np.testing.assert_allclose(
        gemv(ql, tx, radix=radix, backend="bit_serial").numpy(),
        np.asarray(jge.gemv(jql, jx, radix=radix, use_pallas=True,
                            interpret=True)), **TOL)


def test_gemv_takes_numpy_on_the_device_asked_for():
    """An array that is not a tensor goes to ``device`` (here the CPU)."""
    w, x = _data((2,), 64, 16, seed=4)
    jql = jge.quantize_linear(jnp.asarray(w), 8)
    ql = quantize_linear(w, 8, device="cpu")
    np.testing.assert_array_equal(ql.packed.numpy(), np.asarray(jql.packed))
    y = gemv(ql, x, device="cpu", out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(
        y.float().numpy(),
        np.asarray(jge.gemv(jql, jnp.asarray(x), out_dtype=jnp.bfloat16)
                   ).astype(np.float32), rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_engine_dense_matches_jax(bits):
    """Engine off: a plain product of the dense weight; engine on: the
    engine on the quantized weight, as JAX's shim."""
    w, x = _data((2,), 128, 32, seed=6 + bits)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if bits == 0:
        want = np.asarray(jge.engine_dense(jnp.asarray(w), jx))
        got = tge.engine_dense(torch.from_numpy(w), tx)
    else:
        jql = jge.quantize_linear(jnp.asarray(w), bits)
        want = np.asarray(jge.engine_dense(jql, jx, engine_bits=bits))
        got = tge.engine_dense(_port(jql), tx, engine_bits=bits)
    assert got.dtype == torch.float32 and got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_as_packed_takes_quantized_linear(bits):
    """``as_packed`` of the legacy container keeps bytes and sizes, and a
    plan applied to it equals the legacy ``gemv`` exactly."""
    w, x = _data((4,), 256, 64, seed=5)
    jql = jge.quantize_linear(jnp.asarray(w), bits)
    jlin = jax_as_packed(jql)
    lin = as_packed(_port(jql))
    assert isinstance(lin, PackedLinear) and lin.bias is None
    assert (lin.bits, lin.in_features, lin.out_features) == (
        jlin.bits, jlin.in_features, jlin.out_features)
    np.testing.assert_array_equal(lin.packed.numpy(), np.asarray(jlin.packed))
    np.testing.assert_array_equal(lin.scale.numpy(), np.asarray(jlin.scale))
    tx = torch.from_numpy(x)
    for name in ("reference", "bit_serial"):
        y_plan = EnginePlan(backend=name, bits=bits).apply(lin, tx)
        np.testing.assert_array_equal(
            y_plan.numpy(), gemv(_port(jql), tx, backend=name).numpy())
        want = JaxEnginePlan(backend=name, bits=bits).apply(
            jlin, jnp.asarray(x), out_dtype=jnp.float32)
        np.testing.assert_allclose(y_plan.numpy(), np.asarray(want), **TOL)
