"""PyTorch port vs JAX: core numerics of the engine's weight format.

``quantize_symmetric`` and ``pack_weights`` must give the same bytes in both
packages (the serving path hands JAX-packed weights to the port and the
port packs its own), ``unpack_weights`` must invert packing exactly, and
the bit-plane view must reassemble the codes.  Inputs are made with numpy
from a seed and given to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitplane import pack_weights as jax_pack
from repro.core.quantize import quantize_symmetric as jax_quantize

from repro_torch.core import (
    dequantize,
    from_bitplanes,
    pack_weights,
    quantize_symmetric,
    to_bitplanes,
    unpack_weights,
)

torch.set_num_threads(1)

# odd shapes: K a multiple of the codes per byte only, N not a power of two
SHAPES = [(8, 3), (20, 7), (36, 1), (64, 33)]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n", SHAPES)
def test_quantize_and_pack_bytes_equal_jax(bits, k, n):
    rng = np.random.default_rng(k * 100 + n + bits)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 0] = 0.0                       # an all-zero channel gets scale 1
    if n > 1:                           # codes x.5: round half to even
        w[0, -1] = 4.0
        step = np.float32(4.0) / np.float32(2 ** (bits - 1) - 1)
        w[1, -1], w[2, -1] = np.float32(0.5) * step, np.float32(2.5) * step
    jq, js = jax_quantize(jnp.asarray(w), bits, axis=0)
    tq, ts = quantize_symmetric(torch.from_numpy(w), bits, axis=0)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.dtype == torch.float32 and ts.shape == (1, n)
    assert float(ts[0, 0]) == 1.0
    jp = np.asarray(jax_pack(jq, bits, axis=0))
    tp = pack_weights(tq, bits, axis=0)
    assert tp.dtype == torch.int8 and tp.shape == (k * bits // 8, n)
    np.testing.assert_array_equal(tp.numpy(), jp)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_unpack_round_trip_exact(bits, axis):
    """Every code of the signed range, including the most negative one that
    quantization never emits, survives pack -> unpack along either axis."""
    per_byte = 8 // bits
    rng = np.random.default_rng(bits + 10 * axis)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
    shape = [5, 5]
    shape[axis] = 4 * per_byte
    q = rng.integers(lo, hi, size=shape).astype(np.int8)
    packed = pack_weights(torch.from_numpy(q), bits, axis=axis)
    assert packed.shape[axis] == shape[axis] // per_byte
    np.testing.assert_array_equal(
        np.asarray(jax_pack(jnp.asarray(q), bits, axis=axis)), packed.numpy())
    back = unpack_weights(packed, bits, axis=axis)
    np.testing.assert_array_equal(back.numpy(), q)


def test_pack_rejects_ragged_axis():
    with pytest.raises(ValueError):
        pack_weights(torch.zeros((7, 2), dtype=torch.int8), 4, axis=0)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bitplanes_round_trip(bits):
    rng = np.random.default_rng(bits)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
    q = rng.integers(lo, hi, size=(6, 9))
    planes = to_bitplanes(q, bits)
    assert planes.shape == (bits, 6, 9)
    assert set(np.unique(planes)) <= {0, 1}
    np.testing.assert_array_equal(from_bitplanes(planes, bits), q)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_error_bound(bits):
    """|w - deq(q)| <= scale / 2 elementwise (symmetric round to nearest)."""
    rng = np.random.default_rng(40 + bits)
    w = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    q, scale = quantize_symmetric(w, bits)
    err = (w - dequantize(q, scale)).abs()
    assert bool((err <= scale / 2 + 1e-7).all())
    qmax = 2 ** (bits - 1) - 1
    assert int(q.abs().max()) <= qmax
