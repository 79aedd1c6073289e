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
  at the 1e-4 of the second case.
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
