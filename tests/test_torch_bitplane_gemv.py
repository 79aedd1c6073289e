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
balanced schedule of blocks (``_gemv.decode_grid``, each block a
contiguous piece of the (column tile, K step) units) and adds a tile's
pieces' float32 sums in piece order: a plain model of that reduction
(``_decode_model``)
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
def _decode_model(packed, scale, x, bits, grid):
    """The decode route's sums in plain torch on the balanced schedule of
    ``grid`` blocks: each piece of a column tile (``_gemv.decode_pieces``:
    K steps [s0, s1) of 16, ``_gemv.DECODE_K_STEP``) is a float32 sum of
    exact products; a tile's pieces are added in piece order and the sum
    scaled once."""
    w = unpack_weights(packed, bits).float()             # (K, N) codes
    k, n = w.shape
    step, cols = _gemv.DECODE_K_STEP, _gemv.DECODE_COLS
    xf = x.float()
    total = torch.zeros((x.shape[0], n))
    for _, tile, s0, s1 in _gemv.decode_pieces(k, n, grid):
        c0, c1 = tile * cols, min((tile + 1) * cols, n)
        lo, hi = s0 * step, min(s1 * step, k)
        total[:, c0:c1] = total[:, c0:c1] + xf[:, lo:hi] @ w[lo:hi, c0:c1]
    return total * scale


def _split_tiles(k, n, grid):
    tiles = [tile for _, tile, _, _ in _gemv.decode_pieces(k, n, grid)]
    return {t for t in tiles if tiles.count(t) > 1}


@pytest.mark.parametrize("k,n", [(200, 300), (1000, 1003)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_decode_split_model_matches_jax_pallas_interpret(bits, m, xdt, k,
                                                         n):
    """The card's grid for the shape (132 SMs, two blocks each) and one of
    7 blocks, which cuts tiles at other places."""
    jlin, x = _case(bits, (m,), seed=400 + bits * 10 + m + k, k=k, n=n)
    lin = _port_lin(jlin)
    jx = jnp.asarray(x).astype(getattr(jnp, xdt))
    xt = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, xdt))
    assert gemv_kernel.route(m, xt.dtype) == "decode"
    grids = (_gemv.decode_grid(k, n, bits, sms=132, occupancy=2), 7)
    assert any(_split_tiles(k, n, grid) for grid in grids)
    want = np.asarray(jax_gemv(jlin.packed, jlin.scale, jx, bits=bits,
                               radix=1, interpret=True))
    w = unpack_weights(lin.packed, bits).float()
    bound = (2.0 ** -20 * np.sqrt(k)
             * ((xt.float().abs() @ w.abs()) * lin.scale).numpy())
    for grid in grids:
        got = _decode_model(lin.packed, lin.scale, xt, bits, grid)
        err = np.abs(got.numpy() - want)
        assert (err <= bound).all(), (grid, float((err / bound).max()))


def _linears(arch, model=1):
    """(K, N) of a layer's linears and the head of ``arch`` on one rank of
    a ``(1, model)`` mesh: column cuts (wq, wk / wv, w_gate / w_up) divide
    N, row cuts (wo, w_down) K; the head stays whole."""
    from repro_torch.config import get_arch

    c = get_arch(arch)
    d, q, kv = c.d_model, c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return [(d, q // model), (d, kv // model), (q // model, d),
            (d, c.d_ff // model), (c.d_ff // model, d), (d, c.vocab_size)]


SERVING_SHAPES = sorted({shape for arch in ("mistral-large-123b",
                                            "starcoder2-15b", "qwen2.5-3b")
                         for model in (1, 2)
                         for shape in _linears(arch, model)})


@pytest.mark.parametrize("k,n,want", [
    (12288, 12288, 264),   # mistral-large wq / wo: 96 tiles, 192 too few
    (12288, 1024, 264),    # its wk / wv: 8 tiles x 33 pieces fill the card
    (12288, 28672, 224),   # w_gate / w_up: a tile a block, 85% of 264
    (6144, 6144, 240),     # starcoder2 wq / wo: 48 tiles x 5 pieces
    (6144, 512, 96),       # its wk / wv: 16 KB pieces, 1,536 units
    (6144, 49152, 264),    # its head: 384 tiles, pieces across tiles
    (2048, 256, 16),       # qwen2.5-3b wk / wv: 256 units
    (768, 3352, 81),       # mamba2-130m's in_proj: 27 tiles x 48 steps
    (40, 33, 1),           # three K steps of one tile: one block
])
def test_decode_splits(k, n, want):
    """The dense decode grid at 4 bits on 132 SMs holding two blocks each:
    every block the card holds, fewer below 16 KB of codes a piece, or a
    multiple of the tiles that keeps 5/6 of them busy."""
    assert _gemv.decode_grid(k, n, 4, sms=132, occupancy=2) == want


# tiny and ragged K and N: a K step or a tile of their own, a cap under the
# tiles, too few units for the cap, no multiple of the tiles below it
EDGE_SHAPES = [(k, n) for k in (4, 16, 17, 200) for n in (1, 33)]


@pytest.mark.parametrize("occupancy", [1, 2])
@pytest.mark.parametrize("sms", [1, 66, 100, 132])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n", SERVING_SHAPES + EDGE_SHAPES)
def test_decode_splits_leave_no_split_empty(k, n, bits, sms, occupancy):
    """mistral-large-123b's, starcoder2-15b's and qwen2.5-3b's linears and
    heads, their ``(1, 2)`` mesh halves, and tiny and ragged shapes on
    cards of 1 to 132 SMs: every (column tile, K step)
    falls in exactly one piece, in unit order; the blocks' pieces differ
    by at most one step; no block is empty; the grid never exceeds the
    blocks the card holds, nor needs more scratch than the kernel has; and
    the schedule depends on the shapes, the bits and the card only."""
    grid = _gemv.decode_grid(k, n, bits, sms, occupancy)
    assert 1 <= grid <= min(sms * occupancy, _gemv.DECODE_MAX_GRID)
    k_steps = -(-k // _gemv.DECODE_K_STEP)
    units = _gemv.decode_units(k, n)
    assert units == -(-n // _gemv.DECODE_COLS) * k_steps
    pieces = _gemv.decode_pieces(k, n, grid)
    seen, sizes = 0, [0] * grid
    for b, tile, s0, s1 in pieces:
        assert 0 <= s0 < s1 <= k_steps
        assert tile * k_steps + s0 == seen      # the next unit, once
        seen += s1 - s0
        sizes[b] += s1 - s0
    assert seen == units
    assert [p[0] for p in pieces] == sorted(p[0] for p in pieces)
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # the cap: the resident blocks, or as many as give 16 KB pieces
    unit_bytes = _gemv.DECODE_COLS * _gemv.DECODE_K_STEP * bits // 8
    cap = min(sms * occupancy, _gemv.DECODE_MAX_GRID,
              -(-units // max(1, _gemv.DECODE_MIN_PIECE // unit_bytes)))
    tiles = -(-n // _gemv.DECODE_COLS)
    if grid < cap:
        # a multiple of the tiles that keeps 5/6 of the cap busy: every
        # piece inside one tile
        assert grid % tiles == 0 and 6 * grid >= 5 * cap
        assert len(pieces) == grid
    else:
        assert grid == cap
    assert _gemv.decode_grid(k, n, bits, sms, occupancy) == grid
    assert _gemv.decode_pieces(k, n, grid) == pieces


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8])
def test_decode_launch_takes_the_balanced_grid(monkeypatch, m, xdt):
    """The launcher hands the decode entry ``decode_grid``'s blocks for the
    card's SMs and the kernel's occupancy (both replaced here: the kernel
    cannot run on the CPU), counts one decode launch and one balanced."""
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    class Stream:
        cuda_stream = 0

    k, n, bits = 6144, 512, 4
    monkeypatch.setattr(gemv_kernel, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(gemv_kernel, "_entry", entry)
    monkeypatch.setattr(_gemv, "sm_count", lambda dev: 132)
    monkeypatch.setattr(_gemv, "_occupancy", lambda *a: 2)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(_gemv, "_SCRATCH", {})
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(_build, "ROUTE_LAUNCHES", dict(_build.ROUTE_LAUNCHES))
    monkeypatch.setattr(_build, "BALANCED_LAUNCHES", 0)
    packed = torch.zeros((k * bits // 8, n), dtype=torch.int8)
    x = torch.zeros((m, k), dtype=xdt)
    y = gemv_kernel.bitplane_gemv_cuda(packed, torch.ones((1, n)), x,
                                       bits=bits, radix=1, out_dtype=xdt)
    assert y.shape == (m, n) and y.dtype == xdt
    (name, args), = calls
    assert name == "decode"
    assert args[4] == _gemv._SCRATCH[0, 0].data_ptr()
    assert args[5:11] == (m, k, n, bits, 1,
                          _gemv.decode_grid(k, n, bits, 132, 2))
    assert _build.ROUTE_LAUNCHES["bitplane_gemv/decode"] == 1
    assert _build.BALANCED_LAUNCHES == 1


def test_decode_scratch_a_buffer_a_stream(monkeypatch):
    """Each stream's eager launches get a zeroed buffer of their own, the
    same one every time; launches under a capture get the device's graph
    buffer, which the first eager buffer made, so a capture allocates
    nothing."""
    class Stream:
        def __init__(self, handle):
            self.cuda_stream = handle

    state = {"stream": 7, "capturing": False}
    made = []
    zeros = torch.zeros

    def counted_zeros(*args, **kw):
        made.append(state["capturing"])
        return zeros(*args, **kw)

    monkeypatch.setattr(_gemv, "_SCRATCH", {})
    monkeypatch.setattr(torch, "zeros", counted_zeros)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: Stream(state["stream"]))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    dev = torch.device("cpu")
    first = _gemv.decode_scratch(dev)
    assert first.dtype == torch.int32 and not first.any()
    assert first.numel() == _gemv.DECODE_SCRATCH_WORDS == (
        (2 * _gemv.DECODE_ROWS * _gemv.DECODE_COLS + 1)
        * _gemv.DECODE_MAX_GRID)
    assert _gemv.decode_scratch(dev) is first
    state["stream"] = 9
    other = _gemv.decode_scratch(dev)
    assert other is not first and _gemv.decode_scratch(dev) is other
    state["capturing"] = True
    graphs = _gemv.decode_scratch(dev)
    assert graphs is _gemv._SCRATCH[0, None]
    assert graphs is not first and graphs is not other
    assert made == [False, False, False]   # the first call made two


def test_recording_hands_over_the_balanced_count(monkeypatch):
    """A graph's capture takes the balanced count out under its own key,
    and each replay adds it back beside the route counts."""
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(_build, "ROUTE_LAUNCHES", dict(_build.ROUTE_LAUNCHES))
    monkeypatch.setattr(_build, "BALANCED_LAUNCHES", 0)
    with _build.recording() as delta:
        for _ in range(3):
            _build.count("bitplane_gemv", "decode")
            _build.count_balanced()
    assert delta == {"bitplane_gemv": 3, "bitplane_gemv/decode": 3,
                     _build.BALANCED: 3}
    assert _build.BALANCED_LAUNCHES == 0
    _build.add_launches(delta)
    _build.add_launches(delta)
    assert _build.BALANCED_LAUNCHES == 6
    assert _build.ROUTE_LAUNCHES["bitplane_gemv/decode"] == 6
    assert _build.BALANCED not in _build.ROUTE_LAUNCHES
    _build.reset_launches()
    assert _build.BALANCED_LAUNCHES == 0
