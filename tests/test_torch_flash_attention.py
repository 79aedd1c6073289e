"""PyTorch port vs JAX: flash attention.

The same numpy-seeded float32 inputs go through

* the port's plain version (``kernels/flash_attention/ref.py``) and JAX
  ``flash_attention_ref``, in ``(B, H, S, D)`` layout;
* the port's ``ops.flash_attention`` on CPU tensors (which runs the plain
  version) and JAX ``flash_attention(..., interpret=True)``, the Pallas
  kernel interpreted on the CPU, in the model's ``(B, S, H, D)`` layout,
  over the block sizes of ``tests/test_flash_kernel.py`` and a length that
  is not a block multiple (JAX pads, the port does not);
* the port's ``attend_flash`` (plain chunked online softmax) and JAX
  ``attend_flash`` (its jnp path), at the model's blocks and small ones.

Tolerance: rtol = atol = 1e-5, the one ``tests/test_flash_kernel.py``
holds the Pallas kernel to against dense attention (float32 sums in
another order; online vs one-shot softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models.attention import attend_flash as jax_attend_flash

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.attention import attend_flash

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d), dtype=np.float32),
            rng.standard_normal((b, s, hkv, d), dtype=np.float32),
            rng.standard_normal((b, s, hkv, d), dtype=np.float32))


def _bhsd(a):
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("s", [256, 200])
def test_ref_matches_jax_ref(window, group, s):
    q, k, v = (_bhsd(a) for a in _qkv(2, s, 2 * group, 2, 32, seed=s))
    out = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window)
    ref = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128)])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("s", [256, 200])
def test_ops_matches_jax_interpret(bq, bk, window, group, s):
    q, k, v = _qkv(1, s, 2 * group, 2, 16, seed=7 * s + group)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=window)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    window=window, block_q=bq, block_kv=bk, interpret=True)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("window", [0, 5, 64])
@pytest.mark.parametrize("s,bq,bk", [(64, 512, 1024), (96, 32, 64),
                                     (100, 32, 64), (77, 16, 16)])
def test_attend_flash_matches_jax(window, s, bq, bk):
    q, k, v = _qkv(2, s, 4, 2, 16, seed=s + window)
    rng = np.random.default_rng(s)
    # positions offset per row, as a prompt continued from a prefix
    positions = (np.arange(s)[None, :]
                 + rng.integers(0, 9, (2, 1))).astype(np.int32)
    out = attend_flash(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(positions),
                       window, bq, bk)
    ref = jax_attend_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(positions), window, bq, bk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_attend_flash_kernel_route_on_cpu_matches_plain():
    """``attn_backend="cuda"`` on CPU tensors goes through
    ``ops.flash_attention``, which runs the plain version: the same
    function as the chunked path at positions 0..S-1."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 90, 8, 2, 32, seed=3))
    pos = torch.arange(90, dtype=torch.int32).expand(2, 90)
    for window in (0, 17):
        a = attend_flash(q, k, v, pos, window, 32, 32, attn_backend="cuda",
                         sequential=True)
        b = attend_flash(q, k, v, pos, window, 32, 32)
        torch.testing.assert_close(a, b, **TOL)


def test_attend_flash_kernel_route_refuses_given_positions():
    """The kernel masks by index from 0: without the caller's word that
    positions are 0..S-1 it raises instead of ignoring them."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 16))
    pos = torch.arange(16, dtype=torch.int32)[None] + 3
    with pytest.raises(NotImplementedError, match="positions"):
        attend_flash(q, k, v, pos, 0, attn_backend="cuda")
