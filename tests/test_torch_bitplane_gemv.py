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
version are in ``tests/test_torch_cuda_kernels.py``.  What the launcher
decides on the host is held here: which design (``route``) an M and an x
type take, and how the tensor-core route splits K.  A prefill-sized ragged
case (M = 130, K = 136, N = 200, bfloat16 x) goes through the ``ops``
wrapper against the Pallas kernel in interpret mode: float32 output within
the float32 tolerance above (bf16 x converts exactly), bfloat16 output
within one bf16 ulp (rtol 2^-7: one rounding of float32 sums that may
differ in their last bits).  The decode route (M <= 8) splits K over a
cluster of blocks (``_gemv.decode_splits``) and adds the splits' float32
sums in split order: a plain model of that reduction (``_decode_model``)
is held against the Pallas kernel in interpret mode for bits 2 / 4 / 8,
M 1-8, ragged K and N, float32 and bfloat16 x (bf16 x converts exactly,
and every product is exact).  Its K runs to 1000, where the sums grow
past the magnitudes of the cases above, so it takes the bound the repo
holds every K-term float32 sum in two orders to (the int8 baseline's in
``chip_smoke.py`` and ``test_torch_cuda_kernels.py``): 16·√K·2^-24 of
Σ|x|·|w|·scale per element.
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
from repro_torch.kernels import _build, _gemv
from repro_torch.kernels.bitplane_gemv import kernel as gemv_kernel
from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv
from repro_torch.kernels.bitplane_gemv.ref import bitplane_gemv_ref
from repro_torch.core.bitplane import unpack_weights

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


@pytest.mark.parametrize("m,xdt,want", [
    (1, torch.bfloat16, "decode"), (8, torch.bfloat16, "decode"),
    (1, torch.float32, "decode"), (8, torch.float32, "decode"),
    (9, torch.bfloat16, "tensor_core"), (256, torch.bfloat16, "tensor_core"),
    (8192, torch.bfloat16, "tensor_core"), (9, torch.float32, "rows"),
    (256, torch.float32, "rows")])
def test_route_picks_the_design_by_rows_and_type(m, xdt, want):
    assert gemv_kernel.route(m, xdt) == want


@pytest.mark.parametrize("m,n,k,want", [
    (8192, 11008, 2048, 1),     # 64 x 43 tiles fill the card
    (16384, 3352, 768, 1),
    (256, 11008, 2048, 1),      # 2 x 43 = 86 tiles: one split each
    (256, 2048, 2048, 8),       # 16 tiles, 8 splits of 4 K steps
    (256, 2048, 11008, 8),      # 8 splits of 22 K steps
    (256, 256, 2048, 32),       # 2 tiles: one K step a split
    (130, 200, 136, 3),         # 2 tiles, 3 K steps
    (9, 300, 520, 9),           # 1 tile, 9 K steps
])
def test_tensor_core_splits(m, n, k, want):
    assert _gemv.tc_splits(m, n, k, sms=132) == want


@pytest.mark.parametrize("m", [9, 130, 256, 4096])
@pytest.mark.parametrize("n", [200, 256, 3352])
@pytest.mark.parametrize("k", [64, 136, 2048, 11008])
def test_tensor_core_splits_leave_no_split_empty(m, n, k):
    """The C launcher refuses a split count that leaves a split without K,
    and the grid is at most one block per multiprocessor when K is split."""
    bm, bn, bk = _gemv.TC_TILE
    splits = _gemv.tc_splits(m, n, k, sms=132)
    k_steps = -(-k // bk)
    per = -(-k_steps // splits)
    assert 1 <= splits <= k_steps and -(-k_steps // per) == splits
    tiles = -(-m // bm) * -(-n // bn)
    assert splits == 1 or tiles * splits <= 132


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,radix", CASES + [(8, 8)])
def test_prefill_ragged_matches_jax_pallas_interpret(bits, radix, out):
    """M, K and N of no tile's multiple, bfloat16 x: the shape of a ragged
    prefill chunk, which the tensor-core route takes on the card."""
    m, k, n = 130, 136, 200
    jlin, x = _case(bits, (m,), seed=300 + bits * 10 + radix, k=k, n=n)
    lin = _port_lin(jlin)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jdt, tdt = getattr(jnp, out), getattr(torch, out)
    want = np.asarray(jax_gemv(jlin.packed, jlin.scale, xb, bits=bits,
                               radix=radix, interpret=True, out_dtype=jdt)
                      ).astype(np.float32)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    assert gemv_kernel.route(m, xt.dtype) == "tensor_core"
    got = bitplane_gemv(lin.packed, lin.scale, xt, bits=bits, radix=radix,
                        out_dtype=tdt)
    assert got.shape == (m, n) and got.dtype == tdt
    tol = TOL if out == "float32" else dict(rtol=2 ** -7, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


# ------------------------------------------------------ the decode route
def _decode_model(packed, scale, x, bits, splits):
    """The decode route's sums in plain torch: split z of ``splits`` takes
    the K steps [z * per, (z + 1) * per) of 16 (``_gemv.DECODE_K_STEP``),
    its float32 sum of exact products; the splits are added in split order
    and the sum scaled once."""
    w = unpack_weights(packed, bits).float()             # (K, N) codes
    k = w.shape[0]
    step = _gemv.DECODE_K_STEP
    k_steps = -(-k // step)
    per = -(-k_steps // splits)
    xf = x.float()
    total = torch.zeros((x.shape[0], w.shape[1]))
    for z in range(splits):
        lo, hi = z * per * step, min((z + 1) * per * step, k)
        total = total + xf[:, lo:hi] @ w[lo:hi]
    return total * scale


@pytest.mark.parametrize("k,n", [(200, 300), (1000, 1003)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_decode_split_model_matches_jax_pallas_interpret(bits, m, xdt, k,
                                                         n):
    jlin, x = _case(bits, (m,), seed=400 + bits * 10 + m + k, k=k, n=n)
    lin = _port_lin(jlin)
    jx = jnp.asarray(x).astype(getattr(jnp, xdt))
    xt = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, xdt))
    assert gemv_kernel.route(m, xt.dtype) == "decode"
    splits = _gemv.decode_splits(k, n, sms=132)
    assert splits > 1
    want = np.asarray(jax_gemv(jlin.packed, jlin.scale, jx, bits=bits,
                               radix=1, interpret=True))
    got = _decode_model(lin.packed, lin.scale, xt, bits, splits)
    w = unpack_weights(lin.packed, bits).float()
    bound = (2.0 ** -20 * np.sqrt(k)
             * ((xt.float().abs() @ w.abs()) * lin.scale).numpy())
    err = np.abs(got.numpy() - want)
    assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.parametrize("k,n,want", [
    (2048, 2048, 8),      # wq/wo: 16 column tiles, 8 splits
    (2048, 256, 8),       # wk/wv: 2 column tiles
    (2048, 11008, 2),     # w_gate/w_up: 86 column tiles, 172 blocks
    (11008, 2048, 8),     # w_down
    (768, 3352, 5),       # mamba2-130m's in_proj: 27 column tiles
    (1536, 768, 8),       # and its out_proj
    (2048, 151936, 1),    # an untied lm_head fills the card unsplit
    (40, 33, 3),          # three K steps: one each
])
def test_decode_splits(k, n, want):
    assert _gemv.decode_splits(k, n, sms=132) == want


@pytest.mark.parametrize("sms", [1, 66, 132])
@pytest.mark.parametrize("n", [1, 33, 256, 2048, 11008])
@pytest.mark.parametrize("k", [4, 16, 17, 200, 2048, 11008])
def test_decode_splits_leave_no_split_empty(k, n, sms):
    """At most one cluster of 8, every split holds a K step, and the count
    depends on the shapes and the card only; fewer than 8 splits only when
    the column tiles fill the card or K runs out of steps."""
    splits = _gemv.decode_splits(k, n, sms)
    k_steps = -(-k // _gemv.DECODE_K_STEP)
    per = -(-k_steps // splits)
    assert 1 <= splits <= _gemv.DECODE_MAX_SPLITS
    assert splits <= k_steps and -(-k_steps // per) == splits
    tiles = -(-n // _gemv.DECODE_COLS)
    assert (splits == _gemv.DECODE_MAX_SPLITS or tiles * splits >= sms
            or splits * per >= k_steps > (splits - 1) * per)
    assert _gemv.decode_splits(k, n, sms) == splits
