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
Flash attention keeps p in float32 (on the tensor cores, for bfloat16
inputs, as bf16 hi + lo) and takes its online softmax in 64-key steps
where the plain version takes one softmax over the row: float32 outputs
within 1e-5, bfloat16 outputs within one bf16 ulp of the value plus 1e-5
(the sums differ in their last float32 bits before the one rounding).
Flash attention and the chunked prefill pick a design by dtype
(``tensor_core`` for bfloat16, ``cuda_core`` for float32): their cases
check that the route's counter moved.  The SSD scan is chunked float32 arithmetic against the plain
float64 recurrence: within 1e-4 of the largest output (cumulative decays
summed in float32 over a chunk, exponentials of float32 arguments, float32
operands of its tensor-core products split into bf16 hi + lo); its three
passes reduce in a fixed order, so two calls give the same bits.
The int8 bit-parallel GEMV adds K products in float32 in another order than
the plain version: within 16·√K·2^-24 of Σ|x|·|q|·scale per element (one
bf16 ulp more for bfloat16 outputs).  Both GEMVs pick a design by M and the
type of x (``route``): every GEMV case also checks that its route's counter
moved, and the bfloat16 cases at M > 8 (9, 130, 8192; K = 200 and 520,
neither a multiple of the tile's K step; N = 300 and 1983, neither 16- nor
8-byte aligned, and 3352, only 8-byte aligned) take the tensor-core tile.  The engine's exact case feeds integer
weights and activations whose partial sums stay below 2^24, so the tile
model and every kernel must equal ``w @ x`` exactly.  The decode-step
kernels (paged decode attention split over the keys, the GEMVs' decode
route split over K, shared by the int8 baseline at 8 bits) reduce their
splits in a fixed order: their cases also run each call twice and require
the same bits.  Flash attention and the
paged prefill take head dims outside 32 / 64 / 128 / 256 through the launcher's
zero padding (D = 16, 112 and 192 here).

The serving steps as CUDA graphs (``-k graph``): ``decode_step_paged``,
``prefill_chunk`` and the full-sequence ``decode_step`` (dense and ssm),
each captured by ``serve.StepGraph`` on reduced configs cut to 2 layers
(bf16, 4-bit weights), replayed over several steps with new inputs and
held against eager calls of the same function on a copy of the same
state: the same kernels on the same inputs, so logits and caches must be
bit-identical, and each replay must add the launches, by kernel and by
route, that an eager step counts.  ``ServeEngine`` with graphs gives the
same greedy tokens as with ``cuda_graphs=False``, in both modes.  A
prefill chunk graph captured before ``fork_tail_page`` copies a donor page
into a lane's own page in place (the copy-on-write step of a mid-page
prefix-cache hit) reads the copy when it is replayed after it.  A lane
quarantined after NaN was planted in its pages (``-k scrub``): the scrub
zeroes its private pages in place, and the engine's graphs, captured
before it, replay over them and give a clean engine's tokens.  An
in-place ``ServeEngine.restore`` into an engine with captured graphs
(``-k restore``) keeps the pool's and the lane buffers' addresses,
captures nothing, and gives the uninterrupted run's tokens.  On a mesh
(``-k mesh_graph``), two rank processes over ``gloo`` serve with each
step's graph cut into segments at its collectives
(``serve.SegmentedStepGraph``): the eager mesh engine's tokens and
launches, paged and in slots mode.

The dense configs' shapes (``-k dense_groups``): both paged-attention
kernels at G 2 (gemma3-27b, 16 KV heads) and G 12 (starcoder2-15b,
mistral-large-123b: a part-filled second decode pass, a ragged last query
block in a 32-token chunk), over 1,100-2,048 keys with and without
gemma3's 1024-key window.

The bit-plane GEMV's expert-grouped launch (``-k grouped``): stacked
experts at llama4-scout's (K 5120 -> N 8192, 8192 -> 5120; 16 experts) and
qwen3-moe's (4096 -> 1536, 1536 -> 4096; 128 experts) shapes and a ragged
one (K 200, N 300), through each of its three routes (``grouped_decode``
at a bound of 8 rows an expert, ``grouped_tensor_core`` for bfloat16 and
``grouped_rows`` for float32 at 64), with empty experts, every row in one
expert, experts at the bound and ragged counts; the same tolerances as the
flat GEMV, the decode route twice for the same bits.  The MoE serving
steps as graphs (``-k graph_moe``): reduced qwen3-moe and llama4-scout
``decode_step_paged`` / ``prefill_chunk`` replays bit-identical to eager
calls, with the routed experts' counts, and an engine's tokens with graphs
equal to eager.  Head dims past 128 (``-k head_dim_256``): flash attention
(both routes) and the chunked prefill's tensor-core route at D 192
(padded) and 256.  Head dims past 256 (``-k wide_head_dim``): flash
attention at D 300, 320 and 512 in bfloat16 and float32, causal and
windowed, and the chunked prefill at D 320 and 512 over float32, bf16 and
int8 pools, all on their CUDA-core routes.

Training (``-k "grad or train_step"``): every kernel wrapper, the grouped
launch too, raises under grad mode on an input that requires grad and
launches nothing; one train step of a reduced config on the card equals
the same step on the CPU (no kernel runs: the loss takes the plain paths).

A rank of a mesh (``-k mesh``): the bit-plane GEMV at the local shapes
of a ``(1, 2)`` rank of full-width qwen2.5-3b (wq N 1024, wk/wv N 128, wo
K 1024, w_gate/w_up N 5504, w_down K 5504, an untied head's N 75,968) on
its decode route (M 4, 8) and tensor-core route (M 128, 256) in bfloat16
at 4 and 8 bits; every linear of a rank of each family config that
serves on a mesh (an untied head included) at M 2, 8 and 256; both
paged-attention kernels at one KV head with G 8, and at the KV heads of
a rank of each paged family (llava-next, musicgen, llama4-scout,
qwen3-moe); the grouped launch over a rank's experts (llama4-scout 8 of
16, qwen3-moe 64 of 128) on its decode and tensor-core routes; and two
rank processes on the card (``gloo``) running the ``sharded`` backend's
column and row cuts against the unsharded GEMV.  The family shapes are
read from the serving placement (``dist.sharding.rank_shapes``).
The op counter (``-k priced``): each wrapper's call on card tensors under
``roofline.op_cost.counting`` prices one call through the route whose
launch counter moved, and the same call on ``meta`` tensors counts the
same bytes and operations; the launch cells of reduced configs
(``launch.steps``) count the same on the card and on ``meta``, and
their launches by route equal their priced calls.

The vlm, audio and hybrid families (``-k "family or hybrid"``): the
bit-plane GEMV through every route at zamba2-7b's in_proj (ragged N
14576) and out_proj, llava-next's w_down and musicgen's lm_head; flash
attention at zamba2's shared block (D 112 padded, G 1); and reduced
llava, musicgen (paged) and zamba2 (slots) engines with graphs against
eager.
"""

import dataclasses
import json
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

import pytest
import torch

from repro_torch.core import (
    QuantizedLinear,
    gemv,
    pack_weights,
    quantize_symmetric,
)
from repro_torch.config import (
    EngineConfig,
    ServeConfig,
    get_arch,
    get_reduced,
)
from repro_torch.core.controller import run_gemv
from repro_torch.dist.sharding import rank_shapes
from repro_torch.engine import resolve_plan
from repro_torch.core.isa import MAX_ELEMS
from repro_torch.kernels import _build
from repro_torch.kernels._gemv import grouped_route, route
from repro_torch.kernels.bitplane_gemv.ops import (
    bitplane_gemv,
    bitplane_gemv_grouped,
)
from repro_torch.kernels.bitplane_gemv.ref import (
    bitplane_gemv_grouped_ref,
    bitplane_gemv_ref,
)
from repro_torch.kernels.flash_attention.kernel import (
    route as flash_route,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.int8_matvec.ops import int8_matvec
from repro_torch.kernels.int8_matvec.ref import int8_matvec_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.kernel import prefill_route
from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_prefill_attention,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_prefill_ref,
)
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import (
    decode_step,
    decode_step_paged,
    init_cache,
    init_params,
    prefill_chunk,
)
from repro_torch.serve import (
    LaneTables,
    ServeEngine,
    StepGraph,
    fork_tail_page,
    init_kv_pages,
)

CASES = [(bits, radix) for bits in (2, 4, 8) for radix in (1, 2, 4, 8)
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
                                   (40, 2048, 256), (3, 11008, 96),
                                   (9, 200, 300), (130, 520, 1983),
                                   (8192, 200, 3352)])
@pytest.mark.parametrize("bits,radix", CASES)
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_gemv_matches_plain(cuda_device, bits, radix, m, k, n, xdt):
    """Any M, and K and N that are not tile multiples, through each route."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n + bits)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, bits)
    packed = pack_weights(q, bits)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    path = f"bitplane_gemv/{route(m, dt)}"
    before = _build.LAUNCHES["bitplane_gemv"]
    before_route = _build.ROUTE_LAUNCHES[path]
    y = bitplane_gemv(packed, scale, x, bits=bits, radix=radix, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bitplane_gemv"] == before + 1
    assert _build.ROUTE_LAUNCHES[path] == before_route + 1
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


# (K, N) of the decode GEMV cases: qwen2.5-3b's four linears, and K and N
# ragged (K a multiple of the codes a byte holds, of no 16-deep K step)
DECODE_SHAPES = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048),
                 "ragged"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("bits,radix", [(2, 1), (2, 2), (4, 1), (4, 2),
                                        (8, 1), (8, 2)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_gemv_decode_route(cuda_device, xdt, bits, radix, m, shape):
    """The decode route at the decode steps' M (8 paged, 2 and 4 on the
    full-sequence paths, 1 on the engine path): one launch of that route,
    within the tolerance of the plain version, the same bits twice."""
    dt = getattr(torch, xdt)
    k, n = shape if shape != "ragged" else (2001 + (-2001) % (8 // bits),
                                            1003)
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n + bits)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, bits)
    packed = pack_weights(q, bits)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    assert route(m, dt) == "decode"
    before = _build.ROUTE_LAUNCHES["bitplane_gemv/decode"]
    balanced = _build.BALANCED_LAUNCHES
    y = bitplane_gemv(packed, scale, x, bits=bits, radix=radix, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES["bitplane_gemv/decode"] == before + 1
    assert _build.BALANCED_LAUNCHES == balanced + 1
    again = bitplane_gemv(packed, scale, x, bits=bits, radix=radix,
                          out_dtype=dt)
    assert torch.equal(y, again)
    r = bitplane_gemv_ref(packed, scale, x, bits=bits, radix=radix,
                          out_dtype=dt)
    assert y.shape == (m, n) and y.dtype == dt
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol,
                               atol=1e-5 * r.float().abs().max().item())


def _serving_linears(arch, model):
    """(K, N) of a layer's linears and the head of ``arch`` on one rank of
    a ``(1, model)`` mesh (column cuts divide N, row cuts K)."""
    c = get_arch(arch)
    d, q, kv = c.d_model, c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return [(d, q // model), (d, kv // model), (q // model, d),
            (d, c.d_ff // model), (c.d_ff // model, d), (d, c.vocab_size)]


# mistral-large-123b's, starcoder2-15b's and qwen2.5-3b's linears and heads,
# whole and as (1, 2) mesh halves: the balanced schedule's serving shapes
SERVING_SHAPES = sorted({shape for arch in ("mistral-large-123b",
                                            "starcoder2-15b", "qwen2.5-3b")
                         for model in (1, 2)
                         for shape in _serving_linears(arch, model)})


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("k,n", SERVING_SHAPES)
def test_gemv_decode_balanced_serving_shapes(cuda_device, k, n, m):
    """The dense decode launch at the serving shapes, 4 bits, bf16: within
    one bf16 ulp of the plain version, the same bits twice (tiles summed
    from several pieces add them in piece order), one launch of the route
    and one balanced launch each."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, 4)
    del w
    packed = pack_weights(q, 4)
    x = torch.randn((m, k), generator=gen, device=cuda_device).bfloat16()
    before = _build.ROUTE_LAUNCHES["bitplane_gemv/decode"]
    balanced = _build.BALANCED_LAUNCHES
    y = bitplane_gemv(packed, scale, x, bits=4, out_dtype=torch.bfloat16)
    again = bitplane_gemv(packed, scale, x, bits=4, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES["bitplane_gemv/decode"] == before + 2
    assert _build.BALANCED_LAUNCHES == balanced + 2
    assert torch.equal(y, again)
    r = bitplane_gemv_ref(packed, scale, x, bits=4, out_dtype=torch.float32)
    torch.testing.assert_close(y.float(), r, rtol=2 ** -7,
                               atol=1e-5 * r.abs().max().item())


@pytest.mark.cuda
def test_gemv_decode_streams_take_their_own_scratch(cuda_device):
    """Dense decode launches at a shape whose pieces cross tile edges
    (mistral-large-123b's wq), 8 rows, bf16: two side streams running
    at once, each on a scratch buffer of its own, and a CUDA graph replayed
    on a side stream after an event, on the device's graph buffer, give
    the default stream's bits."""
    from repro_torch.kernels import _gemv

    k, n = 12288, 12288
    grid = _gemv.decode_launch_grid(k, n, 4, 8, torch.bfloat16, cuda_device)
    assert len(_gemv.decode_pieces(k, n, grid)) > grid   # pieces cross tiles
    gen = torch.Generator(device=cuda_device).manual_seed(k + n)
    q, scale = quantize_symmetric(
        torch.randn((k, n), generator=gen, device=cuda_device), 4)
    packed = pack_weights(q, 4)
    x = torch.randn((8, k), generator=gen, device=cuda_device).bfloat16()

    def run():
        return bitplane_gemv(packed, scale, x, bits=4,
                             out_dtype=torch.bfloat16)

    want = run()
    side = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    outs = [[], []]
    for s in side:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    for _ in range(20):
        for s, out in zip(side, outs):
            with torch.cuda.stream(s):
                out.append(run())
    buffers = set()
    for s in side:
        with torch.cuda.stream(s):
            buffers.add(_gemv.decode_scratch(cuda_device).data_ptr())
    buffers.add(_gemv.decode_scratch(cuda_device).data_ptr())
    torch.cuda.synchronize()
    assert len(buffers) == 3
    for out in outs:
        for y in out:
            assert torch.equal(y, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_graph = run()
    s = side[0]
    s.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(s):
        y_graph.zero_()
        graph.replay()
    torch.cuda.current_stream(cuda_device).wait_stream(s)
    torch.cuda.synchronize()
    assert torch.equal(y_graph, want)
    assert _gemv._SCRATCH[cuda_device.index or 0, None].data_ptr() \
        not in buffers


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("g", [1, 5, 8, 12])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_decode_attention_splits(cuda_device, kind, g, dh, page):
    """A table of 4096 keys (64 splits), lanes at position 0 (one split
    attended), mid-context and at the last slot; G of 1-12 query heads a KV
    head (one and two passes of 8); one launch, the same bits twice."""
    gen = torch.Generator(device=cuda_device).manual_seed(g + dh + page)
    b, hkv = 4, 2
    nblk = 4096 // page
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                    device=cuda_device).to(qdt)
    pos = torch.tensor([0, 1000, 2222, 4095], dtype=torch.int32,
                       device=cuda_device)
    before = _build.LAUNCHES["paged_decode_attention"]
    y = paged_attention(q, kp, vp, bt, pos, 0, ks, vs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_decode_attention"] == before + 1
    assert torch.equal(y, paged_attention(q, kp, vp, bt, pos, 0, ks, vs))
    r = paged_attention_ref(q, kp, vp, bt, pos, 0, ks, vs)
    assert y.shape == r.shape and y.dtype == qdt
    torch.testing.assert_close(y.float(), r.float(), **_attn_tol(kind))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("g,start", [(8, 0), (1, 0), (4, 0), (8, 260)])
def test_prefill_attention_matches_plain(cuda_device, kind, window, g,
                                         start):
    """Mid-page ``pos0``, a ragged last lane and an idle lane
    (``seq_lens == pos0``, whose rows attend no key and are discarded);
    G of 8, 1 and 4 query heads a KV head; contexts past 256 tokens (several
    steps of the page walk) when ``start`` moves every ``pos0`` on."""
    gen = torch.Generator(device=cuda_device).manual_seed(
        1 + start + 10 * (8 - g))
    b, hkv, dh, page, c = 4, 2, 128, 16, 32
    nblk = 12 + -(-start // page)
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn((b, c, hkv * g, dh), generator=gen,
                    device=cuda_device).to(qdt)
    pos0 = start + torch.tensor([0, 19, 100, 40], dtype=torch.int32,
                                device=cuda_device)
    seq = pos0 + c
    seq[2] -= 7
    seq[3] = pos0[3]
    path = ("paged_prefill_attention/"
            f"{prefill_route(qdt, kp.dtype, dh, g)}")
    before = _build.LAUNCHES["paged_prefill_attention"]
    before_route = _build.ROUTE_LAUNCHES[path]
    y = paged_prefill_attention(q, kp, vp, bt, pos0, seq, window, ks, vs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_prefill_attention"] == before + 1
    assert _build.ROUTE_LAUNCHES[path] == before_route + 1
    assert path.endswith("cuda_core" if kind == "float32" else "tensor_core")
    r = paged_prefill_ref(q, kp, vp, bt, pos0, seq, window, ks, vs)
    torch.testing.assert_close(y[:3].float(), r[:3].float(),
                               **_attn_tol(kind))
    assert bool(torch.isfinite(y[3]).all())


# the dense configs' head groups (Hkv, G): gemma3-27b 16 x 2, starcoder2-15b
# 4 x 12, mistral-large-123b 8 x 12 (decode goes 8 query heads a pass, so
# G 12 leaves a part-filled second pass; the chunked prefill takes 64 // G
# chunk offsets a block, so a 32-token chunk at G 12 ends in a ragged block
# of 2 offsets); gemma3's window of 1024 keys over contexts past it
DENSE_GROUPS = [(16, 2), (4, 12), (8, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("window", [0, 1024])
@pytest.mark.parametrize("hkv,g", DENSE_GROUPS)
def test_decode_attention_dense_groups(cuda_device, kind, window, hkv, g):
    """Decode over a 2048-key table at G 2 and 12, lanes at positions 0,
    1023, 1100, 1500 and 2047 (past the window for the last three), with
    and without gemma3's 1024-key window: one launch, the same bits twice,
    within the plain version's tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(hkv * g + window)
    b, dh, page = 5, 128, 16
    nblk = 2048 // page
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                    device=cuda_device).bfloat16()
    pos = torch.tensor([0, 1023, 1100, 1500, 2047], dtype=torch.int32,
                       device=cuda_device)
    before = _build.LAUNCHES["paged_decode_attention"]
    y = paged_attention(q, kp, vp, bt, pos, window, ks, vs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_decode_attention"] == before + 1
    assert torch.equal(y, paged_attention(q, kp, vp, bt, pos, window, ks,
                                          vs))
    r = paged_attention_ref(q, kp, vp, bt, pos, window, ks, vs)
    assert y.shape == r.shape and y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), r.float(), **_attn_tol(kind))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("window", [0, 1024])
@pytest.mark.parametrize("start", [0, 1100])
@pytest.mark.parametrize("hkv,g", DENSE_GROUPS)
def test_prefill_attention_dense_groups(cuda_device, kind, window, start,
                                        hkv, g):
    """A 32-token chunk at G 2 and 12 (the ragged last query block of G
    12), from ``pos0`` near 0 or past 1,100 keys, with and without the
    1024-key window; a ragged and an idle lane: the tensor-core route,
    one launch, within the plain version's tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(
        hkv * g + window + start)
    b, dh, page, c = 4, 128, 16, 32
    nblk = 12 + -(-start // page)
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    q = torch.randn((b, c, hkv * g, dh), generator=gen,
                    device=cuda_device).bfloat16()
    pos0 = start + torch.tensor([0, 19, 100, 40], dtype=torch.int32,
                                device=cuda_device)
    seq = pos0 + c
    seq[2] -= 7
    seq[3] = pos0[3]
    path = "paged_prefill_attention/tensor_core"
    assert prefill_route(q.dtype, kp.dtype, dh, g) == "tensor_core"
    before = _build.ROUTE_LAUNCHES[path]
    y = paged_prefill_attention(q, kp, vp, bt, pos0, seq, window, ks, vs)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[path] == before + 1
    r = paged_prefill_ref(q, kp, vp, bt, pos0, seq, window, ks, vs)
    torch.testing.assert_close(y[:3].float(), r[:3].float(),
                               **_attn_tol(kind))
    assert bool(torch.isfinite(y[3]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("dh", [16, 112])
def test_prefill_attention_pads_head_dim(cuda_device, kind, dh):
    """Head dims outside the tensor-core tiles' widths: q and the pools
    zero-padded by the launcher, the same route, one launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(dh)
    b, hkv, g, page, c, nblk = 3, 2, 8, 16, 32, 12
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    q = torch.randn((b, c, hkv * g, dh), generator=gen,
                    device=cuda_device).bfloat16()
    pos0 = torch.tensor([0, 45, 150], dtype=torch.int32, device=cuda_device)
    seq = pos0 + c
    before = _build.ROUTE_LAUNCHES["paged_prefill_attention/tensor_core"]
    y = paged_prefill_attention(q, kp, vp, bt, pos0, seq, 0, ks, vs)
    torch.cuda.synchronize()
    assert (_build.ROUTE_LAUNCHES["paged_prefill_attention/tensor_core"]
            == before + 1)
    r = paged_prefill_ref(q, kp, vp, bt, pos0, seq, 0, ks, vs)
    assert y.shape == r.shape
    torch.testing.assert_close(y.float(), r.float(), **_attn_tol(kind))


@pytest.mark.cuda
@pytest.mark.parametrize("s,hq,hkv,d,window", [
    (256, 8, 1, 128, 0), (200, 4, 4, 64, 0), (333, 8, 2, 32, 64),
    (4100, 16, 2, 128, 0), (1030, 16, 2, 128, 1024), (64, 2, 1, 128, 1),
    (300, 4, 2, 16, 0), (1100, 8, 2, 112, 0), (777, 4, 4, 112, 64)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_flash_attention_matches_plain(cuda_device, s, hq, hkv, d, window,
                                       xdt):
    """Ragged S (no padded copy), GQA groups 1-8, head dims 32-128 and
    the zero-padded 16 and 112, windows of 1 key up to 1024, and the
    sequence longer than the window."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(s + hq + d)
    q = torch.randn((2, s, hq, d), generator=gen, device=cuda_device).to(dt)
    k = torch.randn((2, s, hkv, d), generator=gen, device=cuda_device).to(dt)
    v = torch.randn((2, s, hkv, d), generator=gen, device=cuda_device).to(dt)
    path = f"flash_attention/{flash_route(dt, d)}"
    before = _build.LAUNCHES["flash_attention"]
    before_route = _build.ROUTE_LAUNCHES[path]
    y = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert _build.ROUTE_LAUNCHES[path] == before_route + 1
    assert path.endswith("cuda_core" if xdt == "float32" else "tensor_core")
    r = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), window=window).transpose(1, 2)
    assert y.shape == q.shape and y.dtype == dt
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,s,nh,n,chunk", [
    (2, 512, 3, 128, 256), (1, 384, 2, 64, 128), (2, 256, 2, 128, 64),
    (1, 96, 1, 128, 32), (1, 300, 2, 64, 100),
    (1, 256, 24, 128, 256), (2, 256, 24, 64, 256), (1, 4096, 8, 128, 256),
    (2, 4096, 24, 64, 256), (1, 4096, 4, 128, 128), (2, 2048, 24, 64, 64),
    (1, 600, 2, 64, 300), (2, 768, 3, 128, 384)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_ssd_scan_matches_plain(cuda_device, bsz, s, nh, n, chunk, xdt):
    """Chunks of 256 down to 32 steps, a chunk that is not a multiple of
    16, chunks over 256 steps that the kernels cut to 256 (600 steps end
    in a shorter chunk of 88), both state sizes the kernel takes (64:
    zamba2's, 128: mamba2's), 1, 16 and 32 chunks, grids from a few blocks
    to several waves of the card; the same bits from two calls."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(s + nh + n)
    xdt_in = (0.1 * torch.randn((bsz, s, nh, 64), generator=gen,
                                device=cuda_device)).to(dt)
    la = -0.2 * torch.rand((bsz, s, nh), generator=gen, device=cuda_device)
    b_in = torch.randn((bsz, s, n), generator=gen, device=cuda_device).to(dt)
    c_in = torch.randn((bsz, s, n), generator=gen, device=cuda_device).to(dt)
    before = _build.LAUNCHES["ssd_scan"]
    y, h = ssd_scan(xdt_in, la, b_in, c_in, chunk=chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_scan"] == before + 1
    ry, rh = ssd_scan_ref(xdt_in, la, b_in, c_in, chunk)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (bsz, s, nh, 64) and h.shape == (bsz, nh, 64, n)
    for out, ref in ((y, ry), (h, rh)):
        torch.testing.assert_close(out, ref, rtol=1e-4,
                                   atol=1e-4 * ref.abs().max().item())
    again = ssd_scan(xdt_in, la, b_in, c_in, chunk=chunk)
    assert torch.equal(y, again[0]) and torch.equal(h, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 72, 33), (3, 200, 100), (8, 2048, 256),
                                   (9, 520, 300), (40, 2001, 1003),
                                   (256, 2048, 2048), (130, 200, 1983),
                                   (8192, 520, 3352)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_int8_matvec_matches_plain(cuda_device, m, k, n, xdt):
    """Every route (M <= 8, and more rows with float32 or bfloat16 x),
    several K tiles, and K and N that are multiples of neither 4 nor 128
    (byte loads, masked edges), or N only 8-byte aligned."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, 8)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    path = f"int8_matvec/{route(m, dt)}"
    before = _build.LAUNCHES["int8_matvec"]
    before_route = _build.ROUTE_LAUNCHES[path]
    y = int8_matvec(q, scale, x, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["int8_matvec"] == before + 1
    assert _build.ROUTE_LAUNCHES[path] == before_route + 1
    r = int8_matvec_ref(q, scale, x, out_dtype=dt)
    assert y.shape == (m, n) and y.dtype == dt
    s = (x.float().abs() @ q.float().abs()) * scale
    atol = 2.0 ** -20 * math.sqrt(k) * s
    rtol = 0.0 if dt == torch.float32 else 2 ** -7
    err = (y.float() - r.float()).abs()
    assert bool((err <= atol + rtol * r.float().abs()).all()), float(
        err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_int8_matvec_decode_route(cuda_device, monkeypatch, xdt, m, shape):
    """The int8 baseline's decode route is the bit-plane GEMV's decode
    design at 8 bits: one launch of that route on ``decode_launch_grid``'s
    balanced grid for the shape and the card, counted as balanced, within
    the int8 tolerance of the plain version, the same bits twice."""
    from repro_torch.kernels import _gemv
    from repro_torch.kernels.int8_matvec import kernel as int8_kernel

    grids_seen, entry_args = [], []
    real_grid, real_entry = int8_kernel.decode_launch_grid, int8_kernel._entry

    def spy_grid(*args):
        grids_seen.append(real_grid(*args))
        return grids_seen[-1]

    def spy_entry(name):
        fn = real_entry(name)

        def call(*args):
            entry_args.append((name, args))
            return fn(*args)
        return call

    monkeypatch.setattr(int8_kernel, "decode_launch_grid", spy_grid)
    monkeypatch.setattr(int8_kernel, "_entry", spy_entry)
    dt = getattr(torch, xdt)
    k, n = shape if shape != "ragged" else (2001, 1003)
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, 8)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    assert route(m, dt) == "decode"
    before = _build.ROUTE_LAUNCHES["int8_matvec/decode"]
    balanced = _build.BALANCED_LAUNCHES
    y = int8_matvec(q, scale, x, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES["int8_matvec/decode"] == before + 1
    assert _build.BALANCED_LAUNCHES == balanced + 1
    want = _gemv.decode_grid(k, n, 8, _gemv.sm_count(cuda_device),
                             _gemv.decode_occupancy(cuda_device, 8, m, dt))
    assert grids_seen == [want]
    assert 1 <= want <= 2 * _gemv.sm_count(cuda_device)
    (name, args), = entry_args
    assert name == "decode" and args[5:9] == (m, k, n, want)
    assert args[4] == _gemv.decode_scratch(cuda_device).data_ptr()
    again = int8_matvec(q, scale, x, out_dtype=dt)
    assert torch.equal(y, again)
    r = int8_matvec_ref(q, scale, x, out_dtype=dt)
    assert y.shape == (m, n) and y.dtype == dt
    s = (x.float().abs() @ q.float().abs()) * scale
    atol = 2.0 ** -20 * math.sqrt(k) * s
    rtol = 0.0 if dt == torch.float32 else 2 ** -7
    err = (y.float() - r.float()).abs()
    assert bool((err <= atol + rtol * r.float().abs()).all()), float(
        err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [200, 1000])
def test_engine_exact_integer_gemv(cuda_device, d):
    """The tile model, the bit-plane GEMV at radix 1 and 2 and the int8
    kernel all equal ``w @ x`` on integer weights and activations."""
    rng = np.random.default_rng(d)
    r_max = (2 ** 24 - 1) // (d * 127)
    w = rng.integers(-127, 128, size=(d, d))
    x = rng.integers(-r_max, r_max + 1, size=(d,))
    want = (w @ x).astype(np.float64)
    res = run_gemv(w, x, rows=16, cols=-(-d // MAX_ELEMS))
    np.testing.assert_array_equal(res.y, w @ x)
    codes = torch.as_tensor(np.ascontiguousarray(w.T), dtype=torch.int8,
                            device=cuda_device)
    ql = QuantizedLinear(pack_weights(codes, 8),
                         torch.ones((1, d), device=cuda_device), 8, d, d)
    xt = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    before = dict(_build.LAUNCHES)
    outs = [gemv(ql, xt, radix=1), gemv(ql, xt, radix=2),
            int8_matvec(ql.packed, ql.scale, xt)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bitplane_gemv"] == before["bitplane_gemv"] + 2
    assert _build.LAUNCHES["int8_matvec"] == before["int8_matvec"] + 1
    for y in outs:
        np.testing.assert_array_equal(y.double().cpu().numpy(), want)


# ------------------------------------------------- serving steps as graphs
GRAPH_STEPS = 5        # the eager first call, the capture's replay, three


def _graph_model(arch, dev, kv_bits=0):
    cfg = dataclasses.replace(get_reduced(arch), n_layers=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         engine_bits=4)
    plan = resolve_plan(EngineConfig(weight_bits=4, kv_bits=kv_bits),
                        device=dev)
    return cfg, params, plan


def _launch_counts():
    return {**_build.LAUNCHES, **_build.ROUTE_LAUNCHES,
            _build.BALANCED: _build.BALANCED_LAUNCHES}


def _moved(before):
    return {k: v - before[k] for k, v in _launch_counts().items()
            if v != before[k]}


def _random_pool(pages, gen):
    for t in (pages.k, pages.v):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=t.device, dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device))
    for t in (pages.k_scale, pages.v_scale):
        if t is not None:
            t.copy_(torch.rand(t.shape, generator=gen, device=t.device)
                    / 64 + 1e-3)


def _clone_pages(pages):
    return dataclasses.replace(
        pages, **{name: None if getattr(pages, name) is None
                  else getattr(pages, name).clone()
                  for name in ("k", "v", "k_scale", "v_scale")})


def _same_pages(a, b):
    """Equal pools but for the null page 0, where idle lanes and chunk
    padding write in no fixed order and nothing reads."""
    return all((getattr(a, n) is None and getattr(b, n) is None)
               or torch.equal(getattr(a, n)[:, 1:], getattr(b, n)[:, 1:])
               for n in ("k", "v", "k_scale", "v_scale"))


def _replay_against_eager(graph, eager, load, check_state):
    """Each step: ``load(step)`` fills the graph's lane buffers and
    returns the eager call's inputs; the graph's output (a copy: the next
    replay overwrites it) and launch counts must equal the eager call's."""
    for step in range(GRAPH_STEPS):
        inputs = load(step)
        before = _launch_counts()
        out_g = graph().clone()
        torch.cuda.synchronize()
        moved_g = _moved(before)
        before = _launch_counts()
        out_e = eager(*inputs)
        torch.cuda.synchronize()
        moved_e = _moved(before)
        assert moved_g == moved_e and moved_e, (step, moved_g, moved_e)
        assert torch.equal(out_g, out_e), step
        assert torch.isfinite(out_e.float()).all()
        check_state(step)
    assert graph.graph is not None and graph.calls == GRAPH_STEPS


def _paged_inputs(rng, b, nblk, page, span):
    """Block tables and positions with pages mapped for ``span`` tokens
    from each lane's position on (lane i owns pages 1 + i * nblk ...)."""
    bt = np.zeros((b, nblk), np.int32)
    pos = rng.integers(0, nblk * page - span, b).astype(np.int32)
    for lane in range(b):
        used = -(-(int(pos[lane]) + span) // page)
        bt[lane, :used] = 1 + lane * nblk + np.arange(used)
    return bt, pos


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_graph_paged_decode_matches_eager(cuda_device, kv_bits):
    cfg, params, plan = _graph_model("qwen2.5-3b", cuda_device, kv_bits)
    b, nblk, page = 4, 6, 16
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    pages_g = init_kv_pages(cfg, b * nblk + 1, page, kv_bits=kv_bits,
                            device=cuda_device)
    _random_pool(pages_g, gen)
    pages_e = _clone_pages(pages_g)
    lanes = LaneTables(b, cuda_device, max_blocks=nblk)
    graph = StepGraph(lambda: decode_step_paged(
        params, pages_g, lanes.block_tables, lanes.pos, lanes.active,
        lanes.tokens, cfg, plan))
    rng = np.random.default_rng(kv_bits)

    def load(step):
        bt, pos = _paged_inputs(rng, b, nblk, page, 1)
        active = rng.integers(0, 2, b).astype(bool)
        active[step % b] = True
        tokens = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        lanes.load(block_tables=bt, pos=pos, active=active, tokens=tokens)
        return [torch.from_numpy(a).to(cuda_device)
                for a in (bt, pos, active, tokens)]

    _replay_against_eager(
        graph, lambda bt, pos, active, tokens: decode_step_paged(
            params, pages_e, bt, pos, active, tokens, cfg, plan),
        load, lambda step: _same_pages(pages_g, pages_e) or pytest.fail(
            f"pools differ after step {step}"))
    assert graph.launches["bitplane_gemv/decode"] == 7 * cfg.n_layers
    assert graph.launches[_build.BALANCED] == 7 * cfg.n_layers
    assert graph.launches["paged_decode_attention"] == cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_graph_prefill_chunk_matches_eager(cuda_device, kv_bits):
    cfg, params, plan = _graph_model("qwen2.5-3b", cuda_device, kv_bits)
    b, nblk, page, chunk = 4, 6, 16, 16
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    pages_g = init_kv_pages(cfg, b * nblk + 1, page, kv_bits=kv_bits,
                            device=cuda_device)
    _random_pool(pages_g, gen)
    pages_e = _clone_pages(pages_g)
    lanes = LaneTables(b, cuda_device, max_blocks=nblk, chunk=chunk)
    graph = StepGraph(lambda: prefill_chunk(
        params, pages_g, lanes.block_tables, lanes.chunk_tokens,
        lanes.pos0, lanes.seq_lens, cfg, plan))
    rng = np.random.default_rng(10 + kv_bits)

    def load(step):
        bt, pos0 = _paged_inputs(rng, b, nblk, page, chunk)
        seq_lens = pos0 + rng.integers(0, chunk + 1, b).astype(np.int32)
        seq_lens[step % b] = pos0[step % b] + 1
        tokens = rng.integers(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
        lanes.load(block_tables=bt, chunk_tokens=tokens, pos0=pos0,
                   seq_lens=seq_lens)
        return [torch.from_numpy(a).to(cuda_device)
                for a in (bt, tokens, pos0, seq_lens)]

    _replay_against_eager(
        graph, lambda bt, tokens, pos0, seq_lens: prefill_chunk(
            params, pages_e, bt, tokens, pos0, seq_lens, cfg, plan),
        load, lambda step: _same_pages(pages_g, pages_e) or pytest.fail(
            f"pools differ after step {step}"))
    assert graph.launches["bitplane_gemv/tensor_core"] == 7 * cfg.n_layers
    assert (graph.launches["paged_prefill_attention/tensor_core"]
            == cfg.n_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_graph_decode_step_matches_eager(cuda_device, arch):
    cfg, params, plan = _graph_model(arch, cuda_device)
    b, max_len = 4, 64
    cache_g = init_cache(cfg, b, max_len, device=cuda_device)
    cache_e = {k: v.clone() for k, v in cache_g.items()}
    lanes = LaneTables(b, cuda_device)
    graph = StepGraph(lambda: decode_step(
        params, cache_g, lanes.tokens, cfg, plan, active=lanes.active)[0])
    rng = np.random.default_rng(3)

    def load(step):
        active = rng.integers(0, 2, b).astype(bool)
        active[step % b] = True
        tokens = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        lanes.load(active=active, tokens=tokens)
        return [torch.from_numpy(a).to(cuda_device)
                for a in (tokens, active)]

    def same_cache(step):
        for name in cache_g:
            assert torch.equal(cache_g[name], cache_e[name]), (step, name)

    _replay_against_eager(
        graph, lambda tokens, active: decode_step(
            params, cache_e, tokens, cfg, plan, active=active)[0],
        load, same_cache)
    assert int(cache_g["pos"].sum()) > 0
    assert graph.launches["bitplane_gemv/decode"] == (
        (7 if cfg.family == "dense" else 2) * cfg.n_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode", [("qwen2.5-3b", "paged"),
                                       ("qwen2.5-3b", "slots"),
                                       ("mamba2-130m", "slots")])
def test_graph_engine_tokens_match_eager(cuda_device, arch, mode):
    cfg, params, _ = _graph_model(arch, cuda_device)
    kv_bits = 8 if mode == "paged" else 0
    scfg = ServeConfig(max_new_tokens=6, page_size=4, prefill_chunk=5,
                       engine=EngineConfig(weight_bits=4, kv_bits=kv_bits))
    prompts = [list(range(1 + i, 4 + 3 * i)) for i in range(5)]
    out = {}
    for graphs in (True, False):
        eng = ServeEngine(cfg, params, scfg, n_slots=3, max_len=48,
                          mode=mode, cuda_graphs=graphs, device=cuda_device)
        before = _launch_counts()
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        assert eng.cuda_graphs is graphs
        out[graphs] = ([r.output for r in reqs], _moved(before))
        if graphs:
            assert all(g.graph is not None for g in eng._graphs)
            assert len(eng.timings["capture"]) == len(eng._graphs)
    assert out[True][0] == out[False][0]
    assert all(len(o) == 6 for o in out[True][0])
    # the replays counted every launch the eager engine counted
    assert out[True][1] == out[False][1]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_graph_prefill_reads_forked_page(cuda_device, kv_bits):
    """Lane 0 resumes a prompt at position 21 (page 16): block 0 a shared
    page, block 1 the fork target that ``fork_tail_page`` fills from a
    donor page between the capture and the replay.  The replay equals an
    eager chunk over a pool forked the same way (logits and pool), reads
    the donor's first 5 slots through the copy (an unforked pool gives
    other logits for lane 0 only), and the pool keeps its storage."""
    cfg, params, plan = _graph_model("qwen2.5-3b", cuda_device, kv_bits)
    b, nblk, page, chunk = 2, 4, 16, 16
    shared, donor, dst, private = 1, 2, 3, 4
    gen = torch.Generator(device=cuda_device).manual_seed(5 + kv_bits)
    pages_g = init_kv_pages(cfg, 16, page, kv_bits=kv_bits,
                            device=cuda_device)
    _random_pool(pages_g, gen)
    lanes = LaneTables(b, cuda_device, max_blocks=nblk, chunk=chunk)
    graph = StepGraph(lambda: prefill_chunk(
        params, pages_g, lanes.block_tables, lanes.chunk_tokens,
        lanes.pos0, lanes.seq_lens, cfg, plan))
    rng = np.random.default_rng(kv_bits)
    bt = np.zeros((b, nblk), np.int32)
    bt[0, :3] = [shared, dst, private]
    bt[1, :2] = [8, 9]
    pos0 = np.array([page + 5, 3], np.int32)
    seq_lens = pos0 + np.array([chunk, 9], np.int32)

    def load():
        tokens = rng.integers(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
        lanes.load(block_tables=bt, chunk_tokens=tokens, pos0=pos0,
                   seq_lens=seq_lens)
        return [torch.from_numpy(a).to(cuda_device)
                for a in (bt, tokens, pos0, seq_lens)]

    for _ in range(2):                    # the eager call, the capture
        load()
        graph()
    assert graph.graph is not None
    names = [n for n in ("k", "v", "k_scale", "v_scale")
             if getattr(pages_g, n) is not None]
    ptrs = [getattr(pages_g, n).data_ptr() for n in names]
    unforked = _clone_pages(pages_g)
    fork_tail_page(pages_g, donor, dst)
    pages_e = _clone_pages(pages_g)
    inputs = load()
    before = _launch_counts()
    out_g = graph().clone()
    torch.cuda.synchronize()
    assert _moved(before)["paged_prefill_attention/tensor_core"] == (
        cfg.n_layers)
    out_e = prefill_chunk(params, pages_e, *inputs, cfg, plan)
    out_u = prefill_chunk(params, unforked, *inputs, cfg, plan)
    assert torch.equal(out_g, out_e)
    assert _same_pages(pages_g, pages_e)
    assert not torch.equal(out_u[0], out_e[0])
    assert torch.equal(out_u[1], out_e[1])
    for n in names:
        t = getattr(pages_g, n)
        assert torch.equal(t[:, dst, :5], t[:, donor, :5]), n
    assert [getattr(pages_g, n).data_ptr() for n in names] == ptrs


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_graph_replays_over_scrubbed_pages(cuda_device, kv_bits):
    """An engine whose two graphs were captured serves a victim request,
    whose pages then hold NaN (in the values of a bf16 pool, the scales
    of an int8 one) and which is quarantined (retry budget 0).  The scrub
    zeroes the victim's private pages in place (the pool keeps its
    storage); the next request reuses them through the same graphs and
    gets the tokens of a clean engine's eager run."""
    cfg, params, _ = _graph_model("qwen2.5-3b", cuda_device)
    scfg = ServeConfig(max_new_tokens=6, page_size=4, prefill_chunk=5,
                       max_request_retries=0,
                       engine=EngineConfig(weight_bits=4, kv_bits=kv_bits))
    warm, victim_p = [1, 2, 3, 4, 5, 6, 7], list(range(20, 33))
    after_p = [40, 41, 42, 43, 44, 45]

    def engine(graphs):
        return ServeEngine(cfg, params, scfg, n_slots=1, max_len=48,
                           mode="paged", cuda_graphs=graphs,
                           device=cuda_device)

    clean = engine(False)
    want = clean.submit(after_p)
    clean.run()
    eng = engine(True)
    eng.submit(warm)
    eng.run()
    assert all(g.graph is not None for g in eng._graphs)
    victim = eng.submit(victim_p)
    while victim.last_logits is None:
        eng.step()
    private = list(eng.alloc._mapped[0])
    tensors = [t for t in (eng.pages.k, eng.pages.v, eng.pages.k_scale,
                           eng.pages.v_scale) if t is not None]
    ptrs = [t.data_ptr() for t in tensors]
    idx = torch.tensor(private, device=cuda_device)
    poisoned = (eng.pages.k_scale, eng.pages.v_scale) if kv_bits else (
        eng.pages.k, eng.pages.v)
    for t in poisoned:
        t[:, idx] = float("nan")
    eng._fault(0, victim, "nan_logits")
    torch.cuda.synchronize()
    assert victim.finish_reason == "error" and eng.quarantined == 1
    for t in tensors:
        assert not t[:, idx].any()
        assert torch.isfinite(t.float()).all()
    assert [t.data_ptr() for t in tensors] == ptrs
    eng.audit()
    after = eng.submit(after_p)
    eng.step()
    assert set(eng.alloc._mapped[0]) & set(private)
    eng.run()
    torch.cuda.synchronize()
    assert after.output == want.output and len(want.output) == 6
    assert len(eng.timings["capture"]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_graph_engine_restore_in_place(cuda_device, kv_bits):
    """``ServeEngine.restore`` into an engine whose two step graphs are
    captured: the snapshot taken mid-run (lanes prefilling, requests
    queued) is restored after the engine has run to the end; the pool,
    its scales and the lane buffers keep their addresses, no graph is
    captured again, and the restored run gives the uninterrupted run's
    tokens, as does a fresh engine loading the snapshot from disk."""
    import tempfile

    cfg, params, _ = _graph_model("qwen2.5-3b", cuda_device)
    scfg = ServeConfig(max_new_tokens=6, page_size=4, prefill_chunk=5,
                       engine=EngineConfig(weight_bits=4, kv_bits=kv_bits))
    prompts = [list(range(1 + i, 4 + 3 * i)) for i in range(6)]

    def engine():
        return ServeEngine(cfg, params, scfg, n_slots=3, max_len=48,
                           mode="paged", device=cuda_device)

    eng = engine()
    reqs = [eng.submit(p) for p in prompts]
    for _ in range(3):
        eng.step()
    assert eng.queue and any(r.output for r in reqs)
    snap = eng.snapshot()
    eng.run()
    want = {r.rid: r.output for r in reqs}
    assert all(g.graph is not None for g in eng._graphs)
    captures = len(eng.timings["capture"])
    tensors = list(eng._pool_tensors().values()) + list(
        vars(eng.lanes).values())
    ptrs = [t.data_ptr() for t in tensors]
    eng.restore(snap)
    got = {r.rid: r.output for r in eng.run()}
    torch.cuda.synchronize()
    assert got == {rid: want[rid] for rid in got} and len(got) == 6
    assert len(eng.timings["capture"]) == captures
    assert [t.data_ptr() for t in tensors] == ptrs
    with tempfile.TemporaryDirectory() as d:
        eng.restore(snap)
        eng.save_snapshot(d, 3)
        fresh = engine()
        fresh.load_snapshot(d)
        assert {r.rid: r.output for r in fresh.run()} == got



# ------------------------------------------------ grouped (MoE) GEMV
# (K, N, experts): llama4-scout's and qwen3-moe's expert linears, ragged
GROUPED_SHAPES = [(5120, 8192, 16), (8192, 5120, 16), (4096, 1536, 128),
                  (1536, 4096, 128), (200, 300, 6)]


def _grouped_counts(kind, experts, bound, gen, dev):
    """Rows per expert: ``ragged`` (random, some experts empty, one at the
    bound), ``one`` (every row in one expert, at the bound) or ``full``
    (every expert at the bound)."""
    if kind == "one":
        counts = torch.zeros(experts, dtype=torch.int32)
        counts[experts // 2] = bound
    elif kind == "full":
        counts = torch.full((experts,), bound, dtype=torch.int32)
    else:
        counts = torch.randint(0, bound + 1, (experts,), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(
                                   experts + bound))
        counts[::3] = 0
        counts[1] = bound
    return counts.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("counts_kind", ["ragged", "one", "full"])
@pytest.mark.parametrize("shape", GROUPED_SHAPES)
@pytest.mark.parametrize("bound,xdt", [(8, "bfloat16"), (8, "float32"),
                                       (64, "bfloat16"), (64, "float32")])
def test_grouped_gemv_matches_plain(cuda_device, bound, xdt, shape,
                                    counts_kind):
    k, n, experts = shape
    dt = getattr(torch, xdt)
    bits = 4
    gen = torch.Generator(device=cuda_device).manual_seed(k + n + bound)
    packed = torch.randint(-128, 128, (experts, k * bits // 8, n),
                           generator=gen, device=cuda_device,
                           dtype=torch.int8)
    scale = torch.rand((experts, 1, n), generator=gen,
                       device=cuda_device) / 64 + 1e-3
    counts = _grouped_counts(counts_kind, experts, bound, gen, cuda_device)
    offsets = torch.zeros(experts + 1, dtype=torch.int32, device=cuda_device)
    offsets[1:] = torch.cumsum(counts, 0)
    rows = int(offsets[-1])
    x = torch.randn((rows + 5, k), generator=gen,
                    device=cuda_device).to(dt)
    path = f"bitplane_gemv/{grouped_route(bound, dt)}"
    assert path.endswith({8: "grouped_decode", 64: "grouped_tensor_core"
                          if xdt == "bfloat16" else "grouped_rows"}[bound])
    before = _build.ROUTE_LAUNCHES[path]
    y = bitplane_gemv_grouped(packed, scale, x, offsets, max_rows=bound,
                              bits=bits, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[path] == before + 1
    r = bitplane_gemv_grouped_ref(packed, scale, x, offsets, max_rows=bound,
                                  bits=bits, out_dtype=dt)
    assert y.shape == (rows + 5, n) and y.dtype == dt
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y[:rows].float(), r[:rows].float(), rtol=rtol,
                               atol=1e-5 * r.float().abs().max().item())
    if bound == 8:
        again = bitplane_gemv_grouped(packed, scale, x, offsets,
                                      max_rows=bound, bits=bits, out_dtype=dt)
        assert torch.equal(again[:rows], y[:rows])


@pytest.mark.cuda
@pytest.mark.parametrize("bits,radix", [(2, 2), (8, 1), (8, 4)])
@pytest.mark.parametrize("bound,xdt", [(8, "bfloat16"), (8, "float32"),
                                       (40, "bfloat16"), (40, "float32")])
def test_grouped_gemv_bits_match_plain(cuda_device, bits, radix, bound, xdt):
    """The other code widths through each grouped route, on quantized
    weights (ragged K 520, N 300)."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(bits + bound)
    experts, k, n = 5, 520, 300
    w = torch.randn((experts, k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, bits, axis=-2)
    packed = pack_weights(q, bits, axis=-2)
    counts = _grouped_counts("ragged", experts, bound, gen, cuda_device)
    offsets = torch.zeros(experts + 1, dtype=torch.int32, device=cuda_device)
    offsets[1:] = torch.cumsum(counts, 0)
    rows = int(offsets[-1])
    x = torch.randn((rows, k), generator=gen, device=cuda_device).to(dt)
    y = bitplane_gemv_grouped(packed, scale, x, offsets, max_rows=bound,
                              bits=bits, radix=radix, out_dtype=dt)
    r = bitplane_gemv_grouped_ref(packed, scale, x, offsets, max_rows=bound,
                                  bits=bits, radix=radix, out_dtype=dt)
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol,
                               atol=1e-5 * r.float().abs().max().item())


MOE_ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_graph_moe_paged_steps_match_eager(cuda_device, arch):
    """``decode_step_paged`` and ``prefill_chunk`` of a reduced MoE model
    as graphs: each replay bit-identical to an eager call on a copy of the
    state, the routed experts' counts too, with the grouped routes'
    launches (a MoE layer runs its three expert linears grouped)."""
    cfg, params, plan = _graph_model(arch, cuda_device, kv_bits=8)
    b, nblk, page, chunk = 4, 6, 16, 16
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    pages_g = init_kv_pages(cfg, b * nblk + 1, page, kv_bits=8,
                            device=cuda_device)
    _random_pool(pages_g, gen)
    pages_e = _clone_pages(pages_g)
    lanes = LaneTables(b, cuda_device, max_blocks=nblk, chunk=chunk)
    shape = (cfg.n_layers, cfg.n_experts)
    counts_g = torch.zeros(shape, dtype=torch.int32, device=cuda_device)
    counts_e = torch.zeros_like(counts_g)
    rng = np.random.default_rng(20)

    def same(step):
        assert _same_pages(pages_g, pages_e), step
        assert torch.equal(counts_g, counts_e), step

    decode = StepGraph(lambda: decode_step_paged(
        params, pages_g, lanes.block_tables, lanes.pos, lanes.active,
        lanes.tokens, cfg, plan, expert_counts=counts_g))

    def load_decode(step):
        bt, pos = _paged_inputs(rng, b, nblk, page, 1)
        active = rng.integers(0, 2, b).astype(bool)
        active[step % b] = True
        tokens = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        lanes.load(block_tables=bt, pos=pos, active=active, tokens=tokens)
        return [torch.from_numpy(a).to(cuda_device)
                for a in (bt, pos, active, tokens)]

    _replay_against_eager(
        decode, lambda bt, pos, active, tokens: decode_step_paged(
            params, pages_e, bt, pos, active, tokens, cfg, plan,
            expert_counts=counts_e), load_decode, same)
    assert decode.launches["bitplane_gemv/grouped_decode"] == (
        3 * cfg.n_layers)
    prefill = StepGraph(lambda: prefill_chunk(
        params, pages_g, lanes.block_tables, lanes.chunk_tokens,
        lanes.pos0, lanes.seq_lens, cfg, plan, expert_counts=counts_g))

    def load_prefill(step):
        bt, pos0 = _paged_inputs(rng, b, nblk, page, chunk)
        seq_lens = pos0 + rng.integers(0, chunk + 1, b).astype(np.int32)
        tokens = rng.integers(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
        lanes.load(block_tables=bt, chunk_tokens=tokens, pos0=pos0,
                   seq_lens=seq_lens)
        return [torch.from_numpy(a).to(cuda_device)
                for a in (bt, tokens, pos0, seq_lens)]

    _replay_against_eager(
        prefill, lambda bt, tokens, pos0, seq_lens: prefill_chunk(
            params, pages_e, bt, tokens, pos0, seq_lens, cfg, plan,
            expert_counts=counts_e), load_prefill, same)
    assert prefill.launches["bitplane_gemv/grouped_tensor_core"] == (
        3 * cfg.n_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode", [(a, m) for a in MOE_ARCHS
                                       for m in ("paged", "slots")])
def test_graph_moe_engine_tokens_match_eager(cuda_device, arch, mode):
    cfg, params, _ = _graph_model(arch, cuda_device)
    kv_bits = 8 if mode == "paged" else 0
    scfg = ServeConfig(max_new_tokens=6, page_size=4, prefill_chunk=5,
                       engine=EngineConfig(weight_bits=4, kv_bits=kv_bits))
    prompts = [list(range(1 + i, 4 + 3 * i)) for i in range(5)]
    out = {}
    for graphs in (True, False):
        eng = ServeEngine(cfg, params, scfg, n_slots=3, max_len=48,
                          mode=mode, cuda_graphs=graphs, device=cuda_device)
        before = _launch_counts()
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        out[graphs] = ([r.output for r in reqs], _moved(before),
                       dict(eng.experts_touched))
    assert out[True][0] == out[False][0]
    assert out[True][1] == out[False][1]
    assert out[True][2] == out[False][2]
    assert out[True][1]["bitplane_gemv/grouped_decode"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_flash_attention_head_dim_256(cuda_device, xdt, window, d):
    """Head dims past 128: 192 zero-padded to the tiles' 256, and 256."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(d + window)
    s, hq, hkv = 777, 8, 2
    q = torch.randn((2, s, hq, d), generator=gen, device=cuda_device).to(dt)
    k = torch.randn((2, s, hkv, d), generator=gen, device=cuda_device).to(dt)
    v = torch.randn((2, s, hkv, d), generator=gen, device=cuda_device).to(dt)
    path = f"flash_attention/{flash_route(dt, d)}"
    before = _build.ROUTE_LAUNCHES[path]
    y = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[path] == before + 1
    r = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), window=window).transpose(1, 2)
    assert y.shape == q.shape and y.dtype == dt
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("window", [0, 37])
def test_prefill_attention_head_dim_256(cuda_device, kind, d, window):
    """The chunked prefill's tensor-core route at head dims past 128, over
    contexts past one 64-key step, a ragged and an idle lane."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + window)
    b, hkv, g, page, c, nblk = 4, 2, 4, 16, 32, 14
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, d,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    q = torch.randn((b, c, hkv * g, d), generator=gen,
                    device=cuda_device).bfloat16()
    pos0 = torch.tensor([0, 45, 150, 60], dtype=torch.int32,
                        device=cuda_device)
    seq = pos0 + c
    seq[2] -= 7
    seq[3] = pos0[3]
    before = _build.ROUTE_LAUNCHES["paged_prefill_attention/tensor_core"]
    y = paged_prefill_attention(q, kp, vp, bt, pos0, seq, window, ks, vs)
    torch.cuda.synchronize()
    assert (_build.ROUTE_LAUNCHES["paged_prefill_attention/tensor_core"]
            == before + 1)
    r = paged_prefill_ref(q, kp, vp, bt, pos0, seq, window, ks, vs)
    assert y.shape == r.shape
    torch.testing.assert_close(y[:3].float(), r[:3].float(),
                               **_attn_tol(kind))
    assert bool(torch.isfinite(y[3]).all())


# --------------------------- head dims past the tiles, the families' shapes
@pytest.mark.cuda
@pytest.mark.parametrize("d", [300, 320, 512])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_flash_attention_wide_head_dim(cuda_device, xdt, window, d):
    """Head dims past the tiles' 256 (300: not a multiple of the 32-column
    slices): both dtypes on the ``wide`` route's streamed design, D as it
    is, the true-D softmax scale, a window, ragged S and GQA."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(d + window + 7)
    s, hq, hkv = 333, 8, 2
    q = torch.randn((2, s, hq, d), generator=gen, device=cuda_device).to(dt)
    k = torch.randn((2, s, hkv, d), generator=gen, device=cuda_device).to(dt)
    v = torch.randn((2, s, hkv, d), generator=gen, device=cuda_device).to(dt)
    assert flash_route(dt, d) == "wide"
    before = _build.ROUTE_LAUNCHES["flash_attention/wide"]
    y = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES["flash_attention/wide"] == before + 1
    r = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), window=window).transpose(1, 2)
    assert y.shape == q.shape and y.dtype == dt
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("window", [0, 37])
def test_prefill_attention_wide_head_dim(cuda_device, kind, d, window):
    """The chunked prefill past the tiles' 256: bf16 queries over bf16 and
    int8 pools (and float32 over float32) on the CUDA-core route, with
    fewer query rows a block, over contexts past one step, a ragged and an
    idle lane."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + window + 3)
    b, hkv, g, page, c, nblk = 4, 2, 4, 16, 32, 14
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, d,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn((b, c, hkv * g, d), generator=gen,
                    device=cuda_device).to(qdt)
    pos0 = torch.tensor([0, 45, 150, 60], dtype=torch.int32,
                        device=cuda_device)
    seq = pos0 + c
    seq[2] -= 7
    seq[3] = pos0[3]
    assert prefill_route(qdt, kp.dtype, d, g) == "cuda_core"
    before = _build.ROUTE_LAUNCHES["paged_prefill_attention/cuda_core"]
    y = paged_prefill_attention(q, kp, vp, bt, pos0, seq, window, ks, vs)
    torch.cuda.synchronize()
    assert (_build.ROUTE_LAUNCHES["paged_prefill_attention/cuda_core"]
            == before + 1)
    r = paged_prefill_ref(q, kp, vp, bt, pos0, seq, window, ks, vs)
    assert y.shape == r.shape
    torch.testing.assert_close(y[:3].float(), r[:3].float(),
                               **_attn_tol(kind))
    assert bool(torch.isfinite(y[3]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_flash_attention_hybrid_shared_block(cuda_device, xdt):
    """zamba2's shared block: D 112 (zero-padded to the tiles' 128) with
    one query head a KV head (32 of each), past one query tile."""
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(112)
    s, h, d = 600, 32, 112
    q, k, v = (torch.randn((2, s, h, d), generator=gen,
                           device=cuda_device).to(dt) for _ in range(3))
    path = f"flash_attention/{flash_route(dt, d)}"
    before = _build.ROUTE_LAUNCHES[path]
    y = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[path] == before + 1
    r = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2)).transpose(1, 2)
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol, atol=1e-5)


# the last three configs' linears (K, N): zamba2-7b's in_proj (N ragged:
# 2 x 7168 + 2 x 64 + 112) and out_proj, llava-next's w_down (K 14336),
# musicgen-medium's lm_head (2048 x 4 codebooks)
FAMILY_GEMV_SHAPES = [(3584, 14576), (7168, 3584), (14336, 4096),
                      (1536, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FAMILY_GEMV_SHAPES)
@pytest.mark.parametrize("m,xdt", [(1, "bfloat16"), (8, "bfloat16"),
                                   (8, "float32"), (64, "float32"),
                                   (256, "bfloat16")])
def test_gemv_family_shapes(cuda_device, m, xdt, shape):
    """The bit-plane GEMV at 4 bits through each route (decode at M 1 and
    8, rows at 64 float32 rows, the tensor-core tile at a chunk's 256)
    at the vlm, audio and hybrid configs' shapes; the decode route twice
    for the same bits."""
    k, n = shape
    dt = getattr(torch, xdt)
    gen = torch.Generator(device=cuda_device).manual_seed(k + n + m)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, 4)
    packed = pack_weights(q, 4)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    path = f"bitplane_gemv/{route(m, dt)}"
    before = _build.ROUTE_LAUNCHES[path]
    y = bitplane_gemv(packed, scale, x, bits=4, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[path] == before + 1
    if route(m, dt) == "decode":
        again = bitplane_gemv(packed, scale, x, bits=4, out_dtype=dt)
        assert torch.equal(y, again)
    r = bitplane_gemv_ref(packed, scale, x, bits=4, out_dtype=dt)
    assert y.shape == (m, n) and y.dtype == dt
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol,
                               atol=1e-5 * r.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode,layers", [
    ("llava-next-mistral-7b", "paged", 2), ("musicgen-medium", "paged", 2),
    ("zamba2-7b", "slots", 6)])
def test_graph_family_engine_tokens_match_eager(cuda_device, arch, mode,
                                                layers):
    """The vlm (text prompts) and audio (``(n, 1, K)`` / ``(n, C, K)`` lane
    buffers) families served paged on int8 pages, and the hybrid (two
    shared-attention sites) in slots mode: the same greedy tokens and
    launch counts with graphs as eagerly."""
    cfg = dataclasses.replace(get_reduced(arch), n_layers=layers)
    params = init_params(cfg, torch.Generator(device=cuda_device
                                              ).manual_seed(0),
                         engine_bits=4)
    kv_bits = 8 if mode == "paged" else 0
    scfg = ServeConfig(max_new_tokens=6, page_size=4, prefill_chunk=5,
                       engine=EngineConfig(weight_bits=4, kv_bits=kv_bits))
    prompts = [list(range(1 + i, 4 + 3 * i)) for i in range(5)]
    out = {}
    for graphs in (True, False):
        eng = ServeEngine(cfg, params, scfg, n_slots=3, max_len=48,
                          mode=mode, cuda_graphs=graphs, device=cuda_device)
        before = _launch_counts()
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        out[graphs] = ([r.output for r in reqs], _moved(before))
    assert out[True][0] == out[False][0]
    assert all(len(o) == 6 for o in out[True][0])
    assert out[True][1] == out[False][1]
    assert out[True][1]["bitplane_gemv/decode"] > 0


# ----------------------------------------------- kernels under autograd
def grad_cases(device):
    """Each kernel's ``ops`` wrapper with small valid inputs on ``device``
    (drawn on the CPU from a seed): ``{name: (fn, args, kwargs,
    index of the float input that will require grad)}``; the bit-plane
    GEMV's expert-grouped launch among them."""
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    q4, s4 = quantize_symmetric(rnd(64, 48), 4)
    p4 = pack_weights(q4, 4)
    qe, se = zip(*(quantize_symmetric(rnd(64, 48), 4) for _ in range(2)))
    pe = torch.stack([pack_weights(q, 4) for q in qe])
    q8, s8 = quantize_symmetric(rnd(64, 48), 8)
    pools = [rnd(3, 4, 1, 64) for _ in range(2)]
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    cases = {
        "bitplane_gemv": (bitplane_gemv, [p4, s4, rnd(3, 64)],
                          dict(bits=4, radix=1), 2),
        "bitplane_gemv_grouped": (
            bitplane_gemv_grouped,
            [pe, torch.stack(se), rnd(4, 64),
             torch.tensor([0, 2, 4], dtype=torch.int32)],
            dict(max_rows=4, bits=4, radix=1), 2),
        "int8_matvec": (int8_matvec, [q8, s8, rnd(3, 64)], {}, 2),
        "paged_decode_attention": (
            paged_attention, [rnd(1, 1, 2, 64), *pools, bt,
                              torch.tensor([5], dtype=torch.int32)], {}, 0),
        "paged_prefill_attention": (
            paged_prefill_attention,
            [rnd(1, 2, 2, 64), *pools, bt,
             torch.tensor([0], dtype=torch.int32),
             torch.tensor([2], dtype=torch.int32)], {}, 0),
        "flash_attention": (flash_attention,
                            [rnd(1, 8, 2, 64), rnd(1, 8, 1, 64),
                             rnd(1, 8, 1, 64)], {}, 0),
        "ssd_scan": (ssd_scan, [0.1 * rnd(1, 16, 1, 64),
                                -0.2 * torch.rand((1, 16, 1), generator=gen),
                                rnd(1, 16, 64), rnd(1, 16, 64)],
                     dict(chunk=16), 0),
    }
    return {name: (fn, [a.to(device) for a in args], kw, i)
            for name, (fn, args, kw, i) in cases.items()}


GRAD_KERNELS = ("bitplane_gemv", "bitplane_gemv_grouped", "int8_matvec",
                "paged_decode_attention", "paged_prefill_attention",
                "flash_attention", "ssd_scan")


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAD_KERNELS)
def test_kernel_refuses_inputs_that_require_grad(cuda_device, name):
    """A kernel has no backward pass: under grad mode, an input that
    requires grad makes the wrapper raise before it launches (no launch
    counted, nothing detached, no plain version run); under
    ``torch.no_grad()`` the same call launches."""
    fn, args, kw, i = grad_cases(cuda_device)[name]
    args[i].requires_grad_(True)
    before = _launch_counts()
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args, **kw)
    assert _moved(before) == {}
    with torch.no_grad():
        out = fn(*args, **kw)
    torch.cuda.synchronize()
    kernel = "bitplane_gemv" if name == "bitplane_gemv_grouped" else name
    assert _moved(before)[kernel] == 1
    assert not any(t.requires_grad for t in
                   (out if isinstance(out, tuple) else (out,)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_train_step_on_card_matches_cpu(cuda_device, arch):
    """One ``make_train_step`` (AdamW, two microbatches, remat) of a
    reduced config cut to 2 layers in float32, on the card against the
    CPU from the same weights and batch: loss within rtol 1e-4, grad norm
    within rtol 1e-3, params after the update within 2 * lr (Adam's first
    step moves a parameter by about lr whatever its gradient's size, so a
    gradient at float32 noise may take either sign).  No kernel runs."""
    from repro_torch.config import TrainConfig
    from repro_torch.data import DataPipeline
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.weights import stack_layers

    cfg = dataclasses.replace(get_reduced(arch), n_layers=2,
                              dtype="float32")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, microbatches=2)
    host = stack_layers(init_params(cfg, torch.Generator().manual_seed(0)))
    batch = DataPipeline(cfg, batch=4, seq_len=32, seed=0).batch_at(0)
    out = {}
    before = _launch_counts()
    for dev in (cuda_device, torch.device("cpu")):
        params = tree_map(lambda t: t.to(dev, copy=True), host)
        params, _, _, m = make_train_step(cfg, tcfg)(
            params, adamw_init(params), {}, batch)
        out[dev.type] = (m, params)
    torch.cuda.synchronize()
    assert _moved(before) == {}
    (mc, pc), (mh, ph) = out["cuda"], out["cpu"]
    torch.testing.assert_close(mc["loss"].cpu(), mh["loss"], rtol=1e-4,
                               atol=0)
    torch.testing.assert_close(mc["grad_norm"].cpu(), mh["grad_norm"],
                               rtol=1e-3, atol=0)
    for a, b in zip(tree_leaves(pc), tree_leaves(ph)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2 * tcfg.lr)


# ---------------------------------------------------------------- mesh
# (K, N) of a (1, 2) rank of full-width qwen2.5-3b: wq, wk/wv, wo,
# w_gate/w_up, w_down, and an untied head's vocabulary half
MESH_GEMV_SHAPES = [(2048, 1024), (2048, 128), (1024, 2048), (2048, 5504),
                    (5504, 2048), (2048, 75968)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MESH_GEMV_SHAPES)
@pytest.mark.parametrize("m", [4, 8, 128, 256])
@pytest.mark.parametrize("bits", [4, 8])
def test_mesh_gemv_local_shapes(cuda_device, bits, m, shape):
    """The bit-plane GEMV at a mesh rank's local linears, bf16: the decode
    route at M 4 / 8 (twice, the same bits), the tensor-core tile at a
    chunk's M 128 / 256, within the plain version's tolerance."""
    k, n = shape
    dt = torch.bfloat16
    gen = torch.Generator(device=cuda_device).manual_seed(k + n + m + bits)
    w = torch.randn((k, n), generator=gen, device=cuda_device)
    q, scale = quantize_symmetric(w, bits)
    packed = pack_weights(q, bits)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
    path = f"bitplane_gemv/{route(m, dt)}"
    assert route(m, dt) == ("decode" if m <= 8 else "tensor_core")
    before = _build.ROUTE_LAUNCHES[path]
    y = bitplane_gemv(packed, scale, x, bits=bits, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[path] == before + 1
    if m <= 8:
        assert torch.equal(y, bitplane_gemv(packed, scale, x, bits=bits,
                                            out_dtype=dt))
    r = bitplane_gemv_ref(packed, scale, x, bits=bits, out_dtype=dt)
    assert y.shape == (m, n) and y.dtype == dt
    torch.testing.assert_close(y.float(), r.float(), rtol=2 ** -7,
                               atol=1e-5 * r.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_mesh_attention_one_kv_head(cuda_device, kind, mode):
    """Both paged-attention kernels at a (1, 2) rank's heads: one KV head
    of qwen2.5-3b's two, its 8 query heads (G 8), Dh 128, page 16; decode
    with ragged last blocks, a 32-token chunk from mid-page starts."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    b, hkv, g, dh, page, nblk, c = 8, 1, 8, 128, 16, 24, 32
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    if mode == "decode":
        q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                        device=cuda_device).bfloat16()
        pos = torch.tensor([0, 15, 16, 33, 129, 250, 301, page * nblk - 1],
                           dtype=torch.int32, device=cuda_device)
        before = _build.LAUNCHES["paged_decode_attention"]
        y = paged_attention(q, kp, vp, bt, pos, 0, ks, vs)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["paged_decode_attention"] == before + 1
        assert torch.equal(y, paged_attention(q, kp, vp, bt, pos, 0, ks,
                                              vs))
        r = paged_attention_ref(q, kp, vp, bt, pos, 0, ks, vs)
    else:
        q = torch.randn((b, c, hkv * g, dh), generator=gen,
                        device=cuda_device).bfloat16()
        pos0 = torch.tensor([0, 7, 16, 45, 100, 201, 300, 120],
                            dtype=torch.int32, device=cuda_device)
        seq = pos0 + c
        seq[6] = pos0[6] + 5
        path = "paged_prefill_attention/tensor_core"
        before = _build.ROUTE_LAUNCHES[path]
        y = paged_prefill_attention(q, kp, vp, bt, pos0, seq, 0, ks, vs)
        torch.cuda.synchronize()
        assert _build.ROUTE_LAUNCHES[path] == before + 1
        r = paged_prefill_ref(q, kp, vp, bt, pos0, seq, 0, ks, vs)
    assert y.shape == r.shape and y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), r.float(), **_attn_tol(kind))


# the family configs that serve on a mesh, each on a mesh its cells run;
# a rank's shapes are read from the placement, never typed here
MESH_FAMILIES = {"llava-next-mistral-7b": (1, 2), "musicgen-medium": (1, 2),
                 "llama4-scout-17b-a16e": (1, 2),
                 "qwen3-moe-235b-a22b": (1, 2), "qwen2.5-3b": (2, 1),
                 "mamba2-130m": (1, 2), "zamba2-7b": (1, 2),
                 "gemma3-27b": (1, 2)}
MESH_MOE = ["llama4-scout-17b-a16e", "qwen3-moe-235b-a22b"]
MESH_PAGED = ["llava-next-mistral-7b", "musicgen-medium"] + MESH_MOE


def _rank_shapes(arch):
    return rank_shapes(get_arch(arch), MESH_FAMILIES[arch])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 8, 256])
@pytest.mark.parametrize("arch", list(MESH_FAMILIES))
def test_mesh_family_gemv_local_shapes(cuda_device, arch, m):
    """The bit-plane GEMV at every linear of a mesh rank of ``arch`` (its
    untied head included), 4 bits, bf16: the decode route at M 2 / 8, the
    tensor-core tile at M 256, within the plain version's tolerance."""
    dt = torch.bfloat16
    for k, n in _rank_shapes(arch).linears:
        gen = torch.Generator(device=cuda_device).manual_seed(k + n + m)
        q, scale = quantize_symmetric(
            torch.randn((k, n), generator=gen, device=cuda_device), 4)
        packed = pack_weights(q, 4)
        x = torch.randn((m, k), generator=gen, device=cuda_device).to(dt)
        path = f"bitplane_gemv/{route(m, dt)}"
        before = _build.ROUTE_LAUNCHES[path]
        y = bitplane_gemv(packed, scale, x, bits=4, out_dtype=dt)
        torch.cuda.synchronize()
        assert _build.ROUTE_LAUNCHES[path] == before + 1, (k, n)
        r = bitplane_gemv_ref(packed, scale, x, bits=4, out_dtype=dt)
        assert y.shape == (m, n), (k, n)
        torch.testing.assert_close(
            y.float(), r.float(), rtol=2 ** -7,
            atol=1e-5 * r.float().abs().max().item(), msg=f"K {k} N {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("counts_kind", ["ragged", "full"])
@pytest.mark.parametrize("arch", MESH_MOE)
@pytest.mark.parametrize("bound", [8, 64])
def test_mesh_grouped_gemv_local_experts(cuda_device, bound, arch,
                                         counts_kind):
    """The grouped launch over a mesh rank's slice of the experts (the
    ``E_local`` on grid.z, ``offsets (E_local + 1,)``), bf16, through
    grouped_decode (bound 8, twice: the same bits) and
    grouped_tensor_core (64), within the plain version's tolerance, at
    each of the rank's stacked expert linears."""
    for shape in _rank_shapes(arch).experts:
        _grouped_local_experts(cuda_device, bound, shape, counts_kind)


def _grouped_local_experts(cuda_device, bound, shape, counts_kind):
    k, n, experts = shape
    dt = torch.bfloat16
    gen = torch.Generator(device=cuda_device).manual_seed(k + n + experts)
    packed = torch.randint(-128, 128, (experts, k // 2, n), generator=gen,
                           device=cuda_device, dtype=torch.int8)
    scale = torch.rand((experts, 1, n), generator=gen,
                       device=cuda_device) / 64 + 1e-3
    counts = _grouped_counts(counts_kind, experts, bound, gen, cuda_device)
    offsets = torch.zeros(experts + 1, dtype=torch.int32, device=cuda_device)
    offsets[1:] = torch.cumsum(counts, 0)
    rows = int(offsets[-1])
    x = torch.randn((rows + 5, k), generator=gen, device=cuda_device).to(dt)
    path = f"bitplane_gemv/{grouped_route(bound, dt)}"
    assert path.endswith("grouped_decode" if bound == 8
                         else "grouped_tensor_core")
    before = _build.ROUTE_LAUNCHES[path]
    y = bitplane_gemv_grouped(packed, scale, x, offsets, max_rows=bound,
                              bits=4, out_dtype=dt)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[path] == before + 1
    if bound == 8:
        assert torch.equal(y[:rows], bitplane_gemv_grouped(
            packed, scale, x, offsets, max_rows=bound, bits=4,
            out_dtype=dt)[:rows])
    r = bitplane_gemv_grouped_ref(packed, scale, x, offsets, max_rows=bound,
                                  bits=4, out_dtype=dt)
    torch.testing.assert_close(y[:rows].float(), r[:rows].float(),
                               rtol=2 ** -7,
                               atol=1e-5 * r.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MESH_PAGED)
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_mesh_attention_family_heads(cuda_device, kind, arch):
    """Both paged-attention kernels at the KV heads a (1, 2) rank of each
    paged family cell holds: decode, then a 32-token chunk."""
    hkv, g, dh = _rank_shapes(arch).heads
    gen = torch.Generator(device=cuda_device).manual_seed(hkv * g + dh)
    b, page, nblk, c = 8, 16, 24, 32
    kp, vp, ks, vs = _pools(gen, kind, b * nblk + 1, page, hkv, dh,
                            cuda_device)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=cuda_device)
          ).reshape(b, nblk).int()
    pos = torch.tensor([0, 15, 16, 33, 129, 250, 301, page * nblk - 1],
                       dtype=torch.int32, device=cuda_device)
    q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                    device=cuda_device).bfloat16()
    y = paged_attention(q, kp, vp, bt, pos, 0, ks, vs)
    r = paged_attention_ref(q, kp, vp, bt, pos, 0, ks, vs)
    torch.testing.assert_close(y.float(), r.float(), **_attn_tol(kind))
    pos0 = torch.tensor([0, 7, 16, 45, 100, 201, 300, 120],
                        dtype=torch.int32, device=cuda_device)
    seq = pos0 + c
    qp = torch.randn((b, c, hkv * g, dh), generator=gen,
                     device=cuda_device).bfloat16()
    path = "paged_prefill_attention/tensor_core"
    before = _build.ROUTE_LAUNCHES[path]
    y = paged_prefill_attention(qp, kp, vp, bt, pos0, seq, 0, ks, vs)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[path] == before + 1
    r = paged_prefill_ref(qp, kp, vp, bt, pos0, seq, 0, ks, vs)
    torch.testing.assert_close(y.float(), r.float(), **_attn_tol(kind))


MESH_RANK = """
import json, os, sys
sys.path.insert(0, {src!r})
import torch
from repro_torch.core import pack_weights, quantize_symmetric
from repro_torch.dist import close_rank, init_rank, local_shard, make_mesh
from repro_torch.dist.collectives import all_gather
from repro_torch.dist.sharding import param_shardings
from repro_torch.engine import EnginePlan, PackedLinear
from repro_torch.kernels import _build

rank, out = int(sys.argv[1]), sys.argv[2]
init_rank(rank, 2, os.path.join(out, "store"), backend="gloo")
mesh = make_mesh((1, 2), ("data", "model"))
dev = mesh.device
gen = torch.Generator(device=dev).manual_seed(5)
res = {{}}
for name, (k, n) in (("wq", (2048, 1024)), ("wo", (2048, 2048)),
                     ("w_down", (11008, 2048))):
    w = torch.randn((k, n), generator=gen, device=dev)
    q, scale = quantize_symmetric(w, 4)
    lin = PackedLinear(pack_weights(q, 4), scale, None, 4, k, n)
    local = local_shard({{name: lin}}, param_shardings(mesh, {{name: lin}}),
                        mesh)[name]
    sharded = EnginePlan(backend="sharded", bits=4, mesh=mesh,
                         inner_backend="cuda")
    for m in (8, 256):
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        whole = EnginePlan(backend="cuda", bits=4).apply(lin, x)
        if local.shard == "row":
            kl = local.in_features
            y = sharded.apply(local, x[:, rank * kl:(rank + 1) * kl])
        else:
            y = all_gather(sharded.apply(local, x), mesh.group("model"),
                           dim=-1)
        torch.cuda.synchronize()
        err = (y.float() - whole.float()).abs()
        lim = 2 ** -7 * whole.float().abs() + 1e-5 * float(
            whole.float().abs().max())
        res[f"{{name}}/{{m}}"] = dict(shard=local.shard,
                                    ok=bool((err <= lim).all()),
                                    max_err=float(err.max()))
res["routes"] = {{k: v for k, v in _build.ROUTE_LAUNCHES.items()
                 if k.startswith("bitplane_gemv/") and v}}
with open(os.path.join(out, f"rank{{rank}}.json"), "w") as f:
    json.dump(res, f)
close_rank()
"""


@pytest.mark.cuda
def test_mesh_sharded_gemv_two_ranks(cuda_device, tmp_path):
    """Two rank processes on the card (``gloo``): the ``sharded`` backend
    on wq's column cut (output slices gathered) and on wo's and w_down's
    row cuts (float32 partials summed) against the unsharded GEMV on the
    whole weight, at a decode step's M 8 and a chunk's M 256 in bf16,
    within one bf16 ulp plus 1e-5 of the largest output."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    prog = tmp_path / "rank.py"
    prog.write_text(textwrap.dedent(MESH_RANK.format(src=src)))
    procs = [subprocess.Popen([sys.executable, str(prog), str(r),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    for r in range(2):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        routes = res.pop("routes")
        assert routes.get("bitplane_gemv/decode") and routes.get(
            "bitplane_gemv/tensor_core"), routes
        for case, rec in res.items():
            want = "col" if case.startswith("wq") else "row"
            assert rec["shard"] == want and rec["ok"], (r, case, rec)


MESH_GRAPH_RANK = """
import json, os, sys
sys.path.insert(0, {src!r})
import dataclasses
import torch
from repro_torch.config import EngineConfig, ServeConfig, get_reduced
from repro_torch.dist import close_rank, init_rank, make_mesh
from repro_torch.kernels import _build
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine

rank, out = int(sys.argv[1]), sys.argv[2]
shape = tuple(int(v) for v in sys.argv[3].split("x"))
init_rank(rank, 2, os.path.join(out, "store"), backend="gloo")
mesh = make_mesh(shape, ("data", "model"))
torch.cuda.set_device(mesh.device)
cfg = get_reduced("qwen2.5-3b")
params = init_params(cfg, torch.Generator(device=mesh.device).manual_seed(0),
                     engine_bits=4)
prompts = [list(range(1 + i, 4 + 3 * i)) for i in range(5)]
res = {{}}
for mode in ("paged", "slots"):
    kv_bits = 8 if mode == "paged" else 0
    scfg = ServeConfig(max_new_tokens=6, page_size=4, prefill_chunk=5,
                       engine=EngineConfig(weight_bits=4, kv_bits=kv_bits,
                                           sharded=True))
    for graphs in (True, False):
        eng = ServeEngine(cfg, params, scfg, n_slots=4, max_len=48,
                          mode=mode, cuda_graphs=graphs, mesh=mesh)
        before = {{**_build.LAUNCHES, **_build.ROUTE_LAUNCHES}}
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        moved = {{k: v - before[k] for k, v in
                 {{**_build.LAUNCHES, **_build.ROUTE_LAUNCHES}}.items()
                 if v != before[k]}}
        res[f"{{mode}}/{{graphs}}"] = dict(
            tokens=[r.output for r in reqs], launches=moved,
            graphs=eng.cuda_graphs,
            segments=[g.segments for g in eng._graphs],
            captures=len(eng.timings["capture"]),
            collectives=len(eng.timings["collectives"]))
        del eng
with open(os.path.join(out, f"rank{{rank}}.json"), "w") as f:
    json.dump(res, f)
close_rank()
"""


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["1x2", "2x1"])
def test_mesh_graph_engine_tokens_match_eager(cuda_device, tmp_path, shape):
    """Two rank processes on the card (``gloo``) serve reduced qwen2.5-3b
    (4-bit weights through the ``sharded`` backend) paged and in slots
    mode, with segmented graphs and eagerly: every rank's tokens equal
    the eager mesh engine's exactly, and the replays count the launches,
    by kernel and by route, that the eager steps count.  At ``(1, 2)`` a
    step's collectives (the vocabulary lookup's sum, two row-parallel
    sums a layer, the logits' gather) cut it into segments; at ``(2, 1)``
    the model group has one rank and a step is one segment."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    prog = tmp_path / "rank.py"
    prog.write_text(textwrap.dedent(MESH_GRAPH_RANK.format(src=src)))
    procs = [subprocess.Popen([sys.executable, str(prog), str(r),
                               str(tmp_path), shape],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    cfg = get_reduced("qwen2.5-3b")
    # the embedding's sum, wo's and w_down's sums a layer, the gather
    cuts = 2 + 2 * cfg.n_layers if shape == "1x2" else 0
    for r, rec in enumerate(res):
        for mode in ("paged", "slots"):
            g, e = rec[f"{mode}/True"], rec[f"{mode}/False"]
            assert g["graphs"] and not e["graphs"]
            assert g["tokens"] == e["tokens"], (r, mode)
            assert all(len(t) == 6 for t in g["tokens"])
            assert g["tokens"] == res[0][f"{mode}/True"]["tokens"]
            assert g["launches"] == e["launches"], (r, mode)
            assert g["launches"]["bitplane_gemv/decode"] > 0
            assert g["segments"] == [cuts + 1] * len(g["segments"])
            assert g["captures"] == len(g["segments"])
            assert g["collectives"] == e["collectives"]


# the full-sequence path on a mesh (``forward`` / ``prefill(mesh=)``):
# flash attention at the heads a rank holds, the SSD scan on the SSM
# block every rank holds whole; the shapes are read from the placement
SEQ_MESH = [("qwen2.5-3b", (1, 2)), ("qwen2.5-3b", (2, 1)),
            ("llava-next-mistral-7b", (1, 2)), ("musicgen-medium", (1, 2)),
            ("qwen3-moe-235b-a22b", (1, 2)), ("zamba2-7b", (1, 2)),
            ("gemma3-27b", (1, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mesh", SEQ_MESH,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in SEQ_MESH])
def test_mesh_flash_attention_rank_heads(cuda_device, arch, mesh):
    """Flash attention at a rank's query and KV heads (qwen2.5-3b at
    ``(1, 2)``: 8 of 16 query heads, 1 of 2 KV heads), the config's dtype
    and window, over a ragged 1,000-token sequence."""
    cfg = get_arch(arch)
    hkv, g, dh = rank_shapes(cfg, mesh).heads
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(hkv * g + dh)
    s, window = 1000, cfg.sliding_window
    q = torch.randn((2, s, hkv * g, dh), generator=gen,
                    device=cuda_device).to(dt)
    k = torch.randn((2, s, hkv, dh), generator=gen, device=cuda_device).to(dt)
    v = torch.randn((2, s, hkv, dh), generator=gen, device=cuda_device).to(dt)
    path = f"flash_attention/{flash_route(dt, dh)}"
    before = _build.ROUTE_LAUNCHES[path]
    y = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[path] == before + 1
    r = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), window=window).transpose(1, 2)
    assert y.shape == q.shape and y.dtype == dt
    rtol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.float(), r.float(), rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_mesh_ssd_scan_whole_block(cuda_device, arch):
    """The SSD scan on a ``(1, 2)`` rank: the SSM block is whole there
    (``in_proj`` at its full width), so the scan runs every head, at the
    config's chunk, over 2,048 steps."""
    cfg = get_arch(arch)
    nh, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    width = 2 * cfg.d_inner + 2 * n + nh
    assert (cfg.d_model, width) in rank_shapes(cfg, (1, 2)).linears
    gen = torch.Generator(device=cuda_device).manual_seed(nh + n)
    dt = getattr(torch, cfg.dtype)
    bsz, s = 2, 2048
    x = (0.1 * torch.randn((bsz, s, nh, p), generator=gen,
                           device=cuda_device)).to(dt)
    la = -0.2 * torch.rand((bsz, s, nh), generator=gen, device=cuda_device)
    b_in = torch.randn((bsz, s, n), generator=gen, device=cuda_device).to(dt)
    c_in = torch.randn((bsz, s, n), generator=gen, device=cuda_device).to(dt)
    before = _build.LAUNCHES["ssd_scan"]
    y, h = ssd_scan(x, la, b_in, c_in, chunk=cfg.ssm_chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_scan"] == before + 1
    ry, rh = ssd_scan_ref(x, la, b_in, c_in, cfg.ssm_chunk)
    for out, ref in ((y, ry), (h, rh)):
        torch.testing.assert_close(out, ref, rtol=1e-4,
                                   atol=1e-4 * ref.abs().max().item())


# ------------------------------------------------------------ op counter
def _priced_cases(dev):
    """name -> a call of that kernel's wrapper on inputs made on ``dev``
    beforehand, at small shapes."""
    gen = torch.Generator(device="cpu").manual_seed(7)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def ints(lo, hi, *shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen).to(dev, dtype)

    def small(*shape, lo=0.0, span=1.0):
        return (lo + span * torch.rand(shape, generator=gen)).to(dev)

    packed, scale = ints(-128, 128, 64, 96), small(1, 96, lo=0.1)
    gpacked, gscale = ints(-128, 128, 4, 64, 96), small(4, 1, 96, lo=0.1)
    offsets = torch.tensor([0, 3, 3, 7, 8], dtype=torch.int32).to(dev)
    q8, x8, x4 = ints(-127, 128, 128, 96), rnd(8, 128), rnd(4, 128)
    kp, vp = ints(-127, 128, 33, 16, 2, 64), ints(-127, 128, 33, 16, 2, 64)
    ks = small(33, 16, 2, span=0.02).to(torch.bfloat16)
    vs = small(33, 16, 2, span=0.02).to(torch.bfloat16)
    bt = (1 + torch.arange(32, dtype=torch.int32)).reshape(4, 8).to(dev)
    pos = torch.full((4,), 100, dtype=torch.int32).to(dev)
    pos0 = torch.full((4,), 84, dtype=torch.int32).to(dev)
    qd, qp = rnd(4, 1, 8, 64), rnd(4, 16, 8, 64)
    fq, fk, fv = rnd(2, 200, 8, 64), rnd(2, 200, 2, 64), rnd(2, 200, 2, 64)
    sx, sla = rnd(2, 256, 4, 64), small(2, 256, 4, lo=-0.2, span=0.2)
    sb, sc = rnd(2, 256, 64), rnd(2, 256, 64)
    return {
        "bitplane_gemv": lambda: bitplane_gemv(
            packed, scale, x8, bits=4, out_dtype=torch.bfloat16),
        "bitplane_gemv_grouped": lambda: bitplane_gemv_grouped(
            gpacked, gscale, x8, offsets, max_rows=8, bits=4,
            out_dtype=torch.bfloat16),
        "int8_matvec": lambda: int8_matvec(q8, scale, x4,
                                           out_dtype=torch.bfloat16),
        "paged_decode_attention": lambda: paged_attention(
            qd, kp, vp, bt, pos, 0, ks, vs),
        "paged_prefill_attention": lambda: paged_prefill_attention(
            qp, kp, vp, bt, pos0, pos, 0, ks, vs),
        "flash_attention": lambda: flash_attention(fq, fk, fv),
        "ssd_scan": lambda: ssd_scan(sx, sla, sb, sc, chunk=128),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bitplane_gemv", "bitplane_gemv_grouped",
                                    "int8_matvec", "paged_decode_attention",
                                    "paged_prefill_attention",
                                    "flash_attention", "ssd_scan"])
def test_priced_call_is_the_launch(cuda_device, kernel):
    from repro_torch.roofline import op_cost

    counts = {}
    for dev in (cuda_device, torch.device("meta")):
        call = _priced_cases(dev)[kernel]
        before = (dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES))
        with op_cost.counting() as counter:
            call()
        torch.cuda.synchronize()
        counts[dev.type] = counter.result()
        launched = {k: v - before[0][k] for k, v in _build.LAUNCHES.items()
                    if v != before[0][k]}
        routes = {k: v - before[1][k]
                  for k, v in _build.ROUTE_LAUNCHES.items()
                  if v != before[1][k]}
        priced = counts[dev.type]["priced"]
        assert sum(priced.values()) == 1
        if dev.type == "cuda":
            (key,) = priced
            assert launched == {key.split("/")[0]: 1}
            assert routes == ({key: 1} if "/" in key else {})
        else:
            assert not launched and not routes
    for key in ("flops", "bytes", "priced"):
        assert counts["cuda"][key] == counts["meta"][key]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paged_serve", "chunked_prefill", "serve",
                                  "prefill", "train"])
def test_priced_launch_cell_counts_on_card_and_meta(cuda_device, cell):
    from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
    from repro_torch.dist.hints import dry_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline import counted_costs

    cfg = get_reduced("qwen2.5-3b")
    kind, kw = {"paged_serve": ("decode", {"paged": True}),
                "chunked_prefill": ("prefill", {"chunked": True}),
                "serve": ("decode", {}), "prefill": ("prefill", {}),
                "train": ("train", {})}[cell]
    run = RunConfig(model=cfg, shape=ShapeConfig(cell, kind, 128, 4),
                    train=TrainConfig(microbatches=2),
                    serve=ServeConfig(engine=EngineConfig(
                        weight_bits=4, kv_bits=8), page_size=16,
                        prefill_chunk=32))
    fn, args, _ = build_cell(run, make_host_mesh(device=cuda_device),
                             abstract=False, device=cuda_device, **dict(kw))
    fn(*args)
    before = (dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES))
    card = counted_costs(fn, *args)
    torch.cuda.synchronize()
    routes = {k: v - before[1][k] for k, v in _build.ROUTE_LAUNCHES.items()
              if v != before[1][k]}
    launched = {k: v - before[0][k] for k, v in _build.LAUNCHES.items()
                if v != before[0][k]}
    fn, args, _ = build_cell(run, dry_mesh((1, 1), ("data", "model")),
                             **dict(kw))
    meta = counted_costs(fn, *args)
    for key in ("flops", "bytes", "transcendentals", "collectives",
                "priced"):
        assert card[key] == meta[key], key
    assert routes == {k: n for k, n in card["priced"].items()
                      if k in _build.ROUTE_LAUNCHES}
    by_kernel = {}
    for k, n in card["priced"].items():
        by_kernel[k.split("/")[0]] = by_kernel.get(k.split("/")[0], 0) + n
    assert launched == by_kernel
    assert bool(card["priced"]) == (kind != "train")
