"""PyTorch port vs JAX: the bit-plane GEMV and its engine backends.

The same packed weights, scales and activations (numpy, from a seed) go
through JAX ``bitplane_gemv_ref``, JAX's ``reference`` backend and the JAX
Pallas kernel in interpret mode, and through the port's plain version
(``kernels/bitplane_gemv/ref.py``), its ``ops`` wrapper on CPU tensors and
its ``reference`` / ``bit_serial`` backends, over bits {2, 4, 8} x radix
{1, 2, 4} x M in {1, 3, 2*5} with 3-D activations, and K and N that are
not tile multiples.

Tolerance in float32: rtol = atol = 1e-5.  Every product of an activation
and a weight digit is exact in float32; the two packages add the products
in another order, which moves the last bits of sums of magnitude ~10.

The CUDA kernel itself has no CPU mode: its cases against the plain
version are in ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import EngineConfig as JaxEngineConfig
from repro.engine import EnginePlan as JaxEnginePlan
from repro.engine import pack_linear as jax_pack_linear
from repro.engine import resolve_plan as jax_resolve_plan
from repro.kernels.bitplane_gemv.ops import bitplane_gemv as jax_gemv
from repro.kernels.bitplane_gemv.ref import bitplane_gemv_ref as jax_gemv_ref

from repro_torch.config import EngineConfig
from repro_torch.engine import EnginePlan, PackedLinear, resolve_plan
from repro_torch.kernels import _build
from repro_torch.kernels.bitplane_gemv import kernel as gemv_kernel
from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv
from repro_torch.kernels.bitplane_gemv.ref import bitplane_gemv_ref

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
K, N = 72, 33          # neither is a multiple of any kernel tile
CASES = [(bits, radix) for bits in (2, 4, 8) for radix in (1, 2, 4)
         if bits % radix == 0]
LEADS = [(1, 1), (3, 1), (2, 5)]   # M = 1, 3, 2*5 as 3-D activations


def _case(bits, lead, seed, k=K, n=N):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal(lead + (k,)).astype(np.float32)
    lin = jax_pack_linear(jnp.asarray(w), bits, bias=jnp.asarray(bias))
    return lin, x


def _port_lin(jlin):
    return PackedLinear(torch.from_numpy(np.array(jlin.packed)),
                        torch.from_numpy(np.array(jlin.scale)),
                        torch.from_numpy(np.array(jlin.bias)),
                        jlin.bits, jlin.in_features, jlin.out_features)


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("bits,radix", CASES)
def test_plain_gemv_and_backends_match_jax(bits, radix, lead):
    jlin, x = _case(bits, lead, seed=bits * 10 + radix + sum(lead))
    lin = _port_lin(jlin)
    x2 = x.reshape(-1, K)
    want = np.asarray(jax_gemv_ref(jlin.packed, jlin.scale, jnp.asarray(x2),
                                   bits=bits, radix=radix))
    got = bitplane_gemv_ref(lin.packed, lin.scale, torch.from_numpy(x2),
                            bits=bits, radix=radix)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    # the ops wrapper flattens (..., K) and runs the plain version on CPU
    got3 = bitplane_gemv(lin.packed, lin.scale, torch.from_numpy(x),
                         bits=bits, radix=radix)
    assert got3.shape == lead + (N,)
    np.testing.assert_allclose(got3.numpy().reshape(-1, N), want, **TOL)

    # engine backends through EnginePlan.apply, bias included, 3-D input
    jplan = JaxEnginePlan(backend="reference", bits=bits, radix=radix)
    jy = np.asarray(jplan.apply(jlin, jnp.asarray(x)))
    for backend in ("reference", "bit_serial"):
        plan = EnginePlan(backend=backend, bits=bits, radix=radix)
        y = plan.apply(lin, torch.from_numpy(x))
        assert y.shape == lead + (N,) and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), jy, **TOL, err_msg=backend)


@pytest.mark.parametrize("bits,radix", CASES)
def test_plain_gemv_matches_jax_pallas_interpret(bits, radix):
    """The JAX Pallas kernel, run in interpret mode as the JAX package's
    own tests run it on the CPU, against the port's ops wrapper."""
    jlin, x = _case(bits, (2, 5), seed=100 + bits * 10 + radix)
    lin = _port_lin(jlin)
    want = np.asarray(jax_gemv(jlin.packed, jlin.scale, jnp.asarray(x),
                               bits=bits, radix=radix, interpret=True))
    got = bitplane_gemv(lin.packed, lin.scale, torch.from_numpy(x),
                        bits=bits, radix=radix)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bf16_activations_match_jax(bits):
    """bf16 activations and a bf16 output: both packages widen x to float32
    and round once at the end; the results agree to one bf16 ulp."""
    jlin, x = _case(bits, (3, 1), seed=200 + bits)
    lin = _port_lin(jlin)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_gemv_ref(jlin.packed, jlin.scale, xb.reshape(-1, K),
                                   bits=bits, out_dtype=jnp.bfloat16)
                      ).astype(np.float32)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    got = bitplane_gemv(lin.packed, lin.scale, xt, bits=bits,
                        out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy().reshape(-1, N), want,
                               rtol=2 ** -8, atol=1e-5)


def test_auto_resolves_by_device():
    plan = resolve_plan(EngineConfig(weight_bits=4), device="cpu")
    assert plan.backend == "reference" and plan.attn_backend == "gather"
    plan = resolve_plan(EngineConfig(weight_bits=4), device="cuda")
    assert plan.backend == "cuda" and plan.attn_backend == "cuda"
    jplan = jax_resolve_plan(JaxEngineConfig(weight_bits=4))
    assert jplan.backend == "reference"   # the JAX package off the TPU
    assert resolve_plan(EngineConfig(), device="cpu") is None


def test_plan_rejects_bad_names():
    with pytest.raises(KeyError):
        EnginePlan(backend="pallas_tpu", bits=4)
    with pytest.raises(KeyError):
        resolve_plan(EngineConfig(weight_bits=4, attn_backend="flash"),
                     device="cpu")
    with pytest.raises(ValueError):
        EnginePlan(backend="reference", bits=8, radix=3)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's launcher checks its inputs before it builds anything:
    CPU tensors are refused, never run through the plain version."""
    jlin, x = _case(4, (3, 1), seed=5)
    lin = _port_lin(jlin)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="not a CUDA device"):
        gemv_kernel.bitplane_gemv_cuda(lin.packed, lin.scale,
                                       torch.from_numpy(x.reshape(3, K)),
                                       bits=4, radix=1)
    assert _build.LAUNCHES == before
