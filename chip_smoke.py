#!/usr/bin/env python3
"""Drive the PyTorch port of the IMAGine serving stack on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels of ``src/repro_torch/csrc`` and runs
these phases, each printing JSON lines; any failure raises and the script
exits non-zero:

1. ``env``      torch / CUDA versions, the card, its power limit.
2. ``build``    nvcc of every kernel source, in parallel; build seconds.
3. ``parity``   each kernel against its plain PyTorch version on card
                tensors at its path's shapes, with the tolerance; the two
                GEMVs through each of their routes (``decode`` M <= 8, at
                M 1 / 2 / 4 / 8, run twice for the same bits; ``rows``
                float32 x, ``tensor_core`` bfloat16 x at larger M), the
                last at ragged prefill M (100, 8192), K and N (300, 1983,
                3352); paged decode attention's splits over a 4096-key
                table (G 1-12, Dh 64-128, pages 16 / 32, run twice); flash
                attention (D up to 128, padded outside 32 / 64 / 128) and
                the chunked prefill through both of their routes
                (``tensor_core`` bfloat16, ``cuda_core`` float32); the SSD
                scan at 1, 16 and 32 chunks, N 64 and 128, bfloat16 and
                float32 inputs, and chunks over 256 steps that the kernels
                cut, with a shorter last chunk (``SSD_CASES``, every call
                twice: the same bits);
   ``time``     kernel, plain-version and PyTorch-library times at those
                shapes, with the bytes and operations each call needs and
                the least time the card could take for them, and the GEMV
                route each row took (decode rows at M = 8, 2 and 4: the
                paged, ``long`` and ``ssm`` decode steps); with the
                bit-plane GEMV at 8 (radix 1, 2), 4 and 2 bits beside the
                int8 bit-parallel baseline, the card's version of the
                paper's bit-serial against bit-parallel comparison.  The
                rows of the kernels that replaced an earlier design carry
                its time (``earlier_ms``, ``EARLIER_MS``).
4. ``main``     paged serving: ``ServeEngine`` on full-width qwen2.5-3b (36
                layers, bf16, ``EngineConfig(weight_bits=4, kv_bits=8)``):
                16 seeded prompts of 33-300 tokens, 32 new tokens each,
                every decode step and prefill chunk a replayed CUDA graph
                (the seconds of their capture reported apart); then
                ``main_profile``: one ``torch.profiler`` session over four
                decode-only steps (replays) of 8 more prompts, the device
                kernel ms per step by kernel and the device busy share,
                and unprofiled the decode graph's device time over the
                step's host time (``replay_share``); then the 16
                prompts once more with ``cuda_graphs=False``
                (``main_eager``): identical greedy tokens, both runs' tok/s
                and step ms side by side (``main_graphs_vs_eager``).
5. ``second``   the same at ``weight_bits=8, kv_bits=0`` (bf16 KV pages),
                cut to 4 layers: the full-precision attention variants.
6. ``whole``    at 2 layers, full width: the kernel engine against an engine
                on the plain backends (``reference`` GEMV, ``gather``
                attention); same greedy tokens, first-step logits within
                tolerance.
7. ``long``     the full-sequence path: full-width qwen2.5-3b
                (``weight_bits=4``, full-precision slots cache),
                ``init_cache`` for 2 x 4160, one-shot ``prefill`` of two
                seeded 4096-token prompts (flash attention), 32 greedy
                ``decode_step`` s, replays of one CUDA graph.
8. ``ssm``      the same for full-width mamba2-130m (24 layers,
                ``weight_bits=4``): four 4096-token prompts (SSD scan),
                32 decode steps.
9. ``long_whole`` at 2 layers, full width, both models: the kernel path
                (decode steps as graph replays) against the same path
                eager (identical greedy tokens) and against the plain path
                (same greedy tokens, first-step logits within tolerance),
                and ``forward`` over prompt and continuation against
                ``prefill`` + ``decode_step`` logits (teacher forcing).
   ``slots``    slots-mode serving: full-width mamba2-130m
                (``weight_bits=4``), 8 slots, max_len 1024, 16 seeded
                prompts of 33-300 tokens entering by sequential decode, 32
                new tokens each, every step a replayed graph of the
                full-sequence ``decode_step``; then graph against eager
                (identical greedy tokens) at 2 layers, and for qwen2.5-3b
                (``kv_bits=0``) cut to 4 layers.
10. ``engine``   the paper's GEMV engine path: ``repro_torch.paper_demo``
                at dim 96 on the card, then at d = 2048 (qwen2.5-3b's wq)
                and d = 1983 (the largest 8-bit GEMV the U55 holds) the
                cycle-counted tile-controller model, the bit-plane GEMV at
                radix 1 and 2 and the int8 bit-parallel kernel on seeded
                integer weights and activations: all four must equal
                ``w @ x`` exactly.
11. ``kernels`` one line: every kernel, its launches on its path (paged
                serving for the first three, ``long`` and ``ssm`` for flash
                attention and the SSD scan, ``engine`` for the int8
                baseline), its error against the plain version and its
                times; for the two GEMVs a decode record (M = 8) and
                ``prefill`` records (M = 8192 and 256, w_gate/w_up) of the
                tensor-core route, with that route's launches on the same
                paths (``long`` and ``main`` prefill; ``engine``, which
                runs the int8 baseline at M = 1 only, for ``int8_matvec``);
                for every kernel with routes its path's launches by route
                (``routes``) and the route its timed record took.

``main``, ``long`` and ``ssm`` check that the GEMV took its tensor-core
route in every prefill and its decode route in every decode step
(``main`` and ``second`` step by step, through ``ServeEngine.step``,
counting each graph replay as its capture's launches; ``slots`` that
every step launched the decode route once a GEMV for each prompt token
it admitted and for its decode step, and nothing else);
``main`` and ``second`` that every prefill chunk launched the chunked
prefill's tensor-core route once a layer, ``long`` that its prefill
launched flash attention's tensor-core route once a layer and its
CUDA-core route never.

The card's ``nvidia-smi`` name and power limit line and the ``kernels``
line come before the last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
with an error and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): the bounds below are stated against
# these, with the card's power limit printed beside them.
PEAK_HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2 ** 20
SEED = 0
DEVICE = "cuda"

GEMV_SHAPES = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]
GEMV_NAMES = {(2048, 2048): "wq/wo", (2048, 256): "wk/wv",
              (2048, 11008): "w_gate/w_up", (11008, 2048): "w_down",
              (768, 3352): "in_proj", (1536, 768): "out_proj"}
# mamba2-130m's linears (K, N): in_proj to [z, x, B, C, dt], out_proj
SSM_GEMV_SHAPES = [(768, 3352), (1536, 768)]
KERNELS = {
    "bitplane_gemv": dict(
        route="cuda", source="src/repro_torch/csrc/bitplane_gemv.cu",
        replaces="src/repro/kernels/bitplane_gemv/kernel.py:93"),
    "paged_decode_attention": dict(
        route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:144"),
    "paged_prefill_attention": dict(
        route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:312"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:82"),
    "ssd_scan": dict(
        route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:66"),
    "int8_matvec": dict(
        route="cuda", source="src/repro_torch/csrc/int8_matvec.cu",
        replaces="src/repro/kernels/int8_matvec/kernel.py:40"),
}
PAGED_KERNELS = ("bitplane_gemv", "paged_decode_attention",
                 "paged_prefill_attention")
# the full-sequence paths' shapes: qwen2.5-3b attention (Hq 16, Hkv 2,
# D 128) over two 4096-token prompts; mamba2-130m SSD (H 24, P 64, N 128,
# chunk 256) over four
FLASH_SHAPE = dict(b=2, s=4096, hq=16, hkv=2, d=128)
SSD_SHAPE = dict(b=4, s=4096, h=24, p=64, n=128)
# the int8 baseline's ragged case: K and N multiples of neither 4 nor 128
INT8_RAGGED = (2001, 1003)
# the GEMVs' tensor-core route at ragged prefill shapes (K, N): K not a
# multiple of the 64-deep K step, N neither 16- nor 8-byte aligned, or only
# 8-byte aligned (mamba2-130m's in_proj)
TC_RAGGED = [(520, 300), (200, 1983), (768, 3352)]
TC_ROWS = (100, 8192)
# the engine phase's exact GEMVs: qwen2.5-3b's wq (K = N = 2048); the U55's
# largest resident 8-bit square GEMV is added at run time
ENGINE_DIMS = (2048,)
# the SSD scan's parity cases (B, S, H, N, chunk, dtype): the ssm shape at
# 16 and 32 chunks, one chunk, zamba2's state (N 64), float32 inputs, and
# chunks over the kernels' 256 steps (cut to 256: 600 steps end in a chunk
# of 88, 768 in three whole chunks)
SSD_CASES = [(4, 4096, 24, 128, 256, "bfloat16"),
             (4, 4096, 24, 128, 128, "bfloat16"),
             (2, 256, 24, 128, 256, "bfloat16"),
             (2, 4096, 24, 64, 256, "bfloat16"),
             (2, 4096, 24, 128, 256, "float32"),
             (2, 4096, 24, 64, 128, "float32"),
             (1, 256, 8, 128, 256, "float32"),
             (1, 600, 2, 64, 300, "bfloat16"),
             (1, 600, 2, 64, 300, "float32"),
             (2, 768, 3, 128, 384, "bfloat16"),
             (2, 768, 3, 128, 384, "float32")]
# the times of the designs this script's kernels replaced, as it timed
# them on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): the SSD scan's
# one block a (lane, head) at the ssm shape, and the int8 baseline's
# CUDA-core decode route (M, K, N) with bf16 x
EARLIER_MS = {
    "ssd_scan": 3.141,
    ("int8_matvec", 1, 2048, 2048): 0.0160,
    ("int8_matvec", 1, 2048, 256): 0.0150,
    ("int8_matvec", 1, 2048, 11008): 0.0343,
    ("int8_matvec", 1, 11008, 2048): 0.0725,
    ("int8_matvec", 8, 2048, 2048): 0.0176,
    ("int8_matvec", 8, 2048, 256): 0.0167,
    ("int8_matvec", 8, 2048, 11008): 0.0393,
    ("int8_matvec", 8, 11008, 2048): 0.0820,
}


def emit(phase: str, **rec) -> None:
    print(json.dumps({"phase": phase, **rec}), flush=True)


class Phase:
    """Prints a phase's elapsed seconds when it ends; errors propagate."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            emit("elapsed", of=self.name,
                 seconds=time.perf_counter() - self.t0)
        return False


# --------------------------------------------------------------- timing
def timed_ms(fn, arg_sets, torch):
    """Mean device milliseconds of ``fn(*args)`` over ``arg_sets``.

    The argument sets rotate so that the bytes touched across the run
    exceed the L2 cache, as the main path finds its weights and pages cold.
    A sleep kernel holds the stream while the host enqueues every launch,
    so the time is the card's alone and not the host's launch rate.
    """
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for args in arg_sets:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(arg_sets)


def n_copies(bytes_per_call: int) -> int:
    return max(8, min(200, math.ceil(2 * L2_BYTES / max(bytes_per_call, 1))))


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / PEAK_HBM_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_close(name, y, r, rtol, atol, **info):
    """Elementwise ``|y - r| <= atol + rtol * |r|``; returns the largest
    absolute error and the largest share of the bound an element used,
    and raises with the case when the bound does not hold."""
    import torch

    y, r = y.float(), r.float()
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{name}: non-finite output {info}")
    err = (y - r).abs()
    used = err / (atol + rtol * r.abs())
    if bool((used > 1).any()):
        raise AssertionError(
            f"{name}: {int((used > 1).sum())} elements outside rtol={rtol} "
            f"atol={atol}, max error {float(err.max())} {info}")
    return float(err.max()), float(used.max())


# ---------------------------------------------------------- GEMV phase
def gemv_case(torch, dev, gen, bits, k, n, m, dt):
    from repro_torch.core import pack_weights, quantize_symmetric

    w = torch.randn((k, n), generator=gen, device=dev)
    q, scale = quantize_symmetric(w, bits)
    packed = pack_weights(q, bits)
    x = torch.randn((m, k), generator=gen, device=dev).to(dt)
    return packed, scale, x


def gemv_tol(dt, r):
    # float32: the sum order differs from the plain version's; bfloat16
    # output: one rounding of a float32 sum that may differ in its last
    # bits, so one bf16 ulp (at most 2^-7 of the value).  atol scales with
    # the largest output.
    import torch

    big = float(r.float().abs().max())
    if dt == torch.float32:
        return 1e-5, 1e-5 * big
    return 2 ** -7, 1e-5 * big


def route_counts(kernel, counts=None):
    """The launches of ``kernel`` by route since the last reset (or in
    ``counts``, a copy of ``_build.ROUTE_LAUNCHES``)."""
    from repro_torch.kernels import _build

    counts = _build.ROUTE_LAUNCHES if counts is None else counts
    return {k.split("/")[1]: v for k, v in counts.items()
            if k.startswith(kernel + "/")}


def gemv_parity(torch, dev):
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv
    from repro_torch.kernels.bitplane_gemv.ref import bitplane_gemv_ref

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst, worst_used, n_cases = 0.0, 0.0, 0
    for bits in (2, 4, 8):
        for radix in (1, 2, 4, 8):
            if bits % radix:
                continue
            # the decode steps' M (8 paged, 2 and 4 full-sequence, 1 the
            # engine) at the main shapes and K, N ragged; and M = 256
            ragged = (INT8_RAGGED[0] + -INT8_RAGGED[0] % (8 // bits),
                      INT8_RAGGED[1])
            for (k, n) in GEMV_SHAPES + [ragged]:
                for m in (1, 2, 4, 8, 256):
                    for dt in (torch.float32, torch.bfloat16):
                        packed, scale, x = gemv_case(torch, dev, gen, bits,
                                                     k, n, m, dt)
                        y = bitplane_gemv(packed, scale, x, bits=bits,
                                          radix=radix, out_dtype=dt)
                        r = bitplane_gemv_ref(packed, scale, x, bits=bits,
                                              radix=radix, out_dtype=dt)
                        rtol, atol = gemv_tol(dt, r)
                        err, used = check_close(
                            "bitplane_gemv", y, r, rtol, atol, bits=bits,
                            radix=radix, m=m, k=k, n=n, dtype=str(dt))
                        if m <= 8 and not torch.equal(y, bitplane_gemv(
                                packed, scale, x, bits=bits, radix=radix,
                                out_dtype=dt)):
                            raise AssertionError(
                                f"bitplane_gemv decode M={m} K={k} N={n}: "
                                "two runs differ")
                        worst = max(worst, err)
                        worst_used = max(worst_used, used)
                        n_cases += 1
            # ragged prefill M, K and N: the tensor-core route in bf16,
            # the rows route in float32 (at M = 100)
            for (k, n) in TC_RAGGED:
                for m in TC_ROWS:
                    for dt in ((torch.float32, torch.bfloat16) if m < 1000
                               else (torch.bfloat16,)):
                        packed, scale, x = gemv_case(torch, dev, gen, bits,
                                                     k, n, m, dt)
                        y = bitplane_gemv(packed, scale, x, bits=bits,
                                          radix=radix, out_dtype=dt)
                        r = bitplane_gemv_ref(packed, scale, x, bits=bits,
                                              radix=radix, out_dtype=dt)
                        rtol, atol = gemv_tol(dt, r)
                        err, used = check_close(
                            "bitplane_gemv", y, r, rtol, atol, bits=bits,
                            radix=radix, m=m, k=k, n=n, dtype=str(dt))
                        worst = max(worst, err)
                        worst_used = max(worst_used, used)
                        n_cases += 1
    torch.cuda.synchronize()
    routes = route_counts("bitplane_gemv")
    if not all(routes.values()):
        raise AssertionError(f"bitplane_gemv parity missed a route: {routes}")
    emit("parity", kernel="bitplane_gemv", cases=n_cases,
         sweep="bits{2,4,8} x radix{1,2,4,8} x (M{1,2,4,8,256} x (4 "
               "shapes + K 2001-2004 x N 1003) x {float32,bfloat16} + "
               "M{100,8192} x (K,N){(520,300),(200,1983),(768,3352)} x "
               "bfloat16, float32 at M=100); decode M run twice, the same "
               "bits",
         tolerance="float32: rtol 1e-5, atol 1e-5*max|ref|; bfloat16 "
                   "output: rtol 2^-7 (one ulp), atol 1e-5*max|ref|",
         max_abs_err=worst, max_share_of_tol=worst_used, routes=routes)


def gemv_time(torch, dev, m, k, n, bits=4, radix=1, dt=None):
    from repro_torch.core import unpack_weights
    from repro_torch.kernels._gemv import route
    from repro_torch.kernels.bitplane_gemv.kernel import bitplane_gemv_cuda
    from repro_torch.kernels.bitplane_gemv.ref import bitplane_gemv_ref

    dt = dt or torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + m + k + n)
    packed, scale, x = gemv_case(torch, dev, gen, bits, k, n, m, dt)
    y = bitplane_gemv_cuda(packed, scale, x, bits=bits, radix=radix,
                           out_dtype=dt)
    r = bitplane_gemv_ref(packed, scale, x, bits=bits, radix=radix,
                          out_dtype=dt)
    rtol, atol = gemv_tol(dt, r)
    err, _ = check_close("bitplane_gemv", y, r, rtol, atol, m=m, k=k, n=n)
    xb = x.element_size()
    n_bytes = k * n * bits // 8 + 4 * n + m * k * xb + m * n * xb
    n_ops = 2 * m * k * n
    dname = "bfloat16" if dt == torch.bfloat16 else "float32"
    bms, by = bound_ms(n_bytes, n_ops, dname)
    copies = n_copies(k * n * bits // 8)
    packs = [packed.clone() for _ in range(copies)]
    ms = timed_ms(lambda p: bitplane_gemv_cuda(p, scale, x, bits=bits,
                                               radix=radix, out_dtype=dt),
                  [(p,) for p in packs], torch)
    plain = timed_ms(lambda p: bitplane_gemv_ref(p, scale, x, bits=bits,
                                                 radix=radix, out_dtype=dt),
                     [(p,) for p in packs[:8]], torch)
    del packs
    w_deq = (unpack_weights(packed, bits).float() * scale).to(dt)
    lib_copies = [w_deq.clone() for _ in
                  range(n_copies(w_deq.numel() * w_deq.element_size()))]
    lib = timed_ms(lambda w: torch.matmul(x, w), [(w,) for w in lib_copies],
                   torch)
    del lib_copies
    rec = dict(kernel="bitplane_gemv", linear=GEMV_NAMES.get((k, n), ""),
               m=m, k=k, n=n, bits=bits, radix=radix, dtype=dname,
               gemv_route=route(m, dt),
               max_abs_err=err, tol=dict(rtol=rtol, atol=atol), ms=ms,
               plain_ms=plain, library_ms=lib, library="torch.matmul on "
               "the dequantized weight", bytes=n_bytes, ops=n_ops,
               bound_ms=bms, bound_by=by)
    emit("time", **rec)
    return rec


# ----------------------------------------------------- attention phase
def attn_pools(torch, dev, gen, kind, n_pages, page, hkv, dh):
    if kind == "int8":
        kp = torch.randint(-127, 128, (n_pages, page, hkv, dh), generator=gen,
                           device=dev).to(torch.int8)
        vp = torch.randint(-127, 128, (n_pages, page, hkv, dh), generator=gen,
                           device=dev).to(torch.int8)
        ks = (0.004 + 0.016 * torch.rand((n_pages, page, hkv), generator=gen,
                                         device=dev)).to(torch.bfloat16)
        vs = (0.004 + 0.016 * torch.rand((n_pages, page, hkv), generator=gen,
                                         device=dev)).to(torch.bfloat16)
        return kp, vp, ks, vs
    dt = getattr(torch, kind)
    kp = torch.randn((n_pages, page, hkv, dh), generator=gen, device=dev)
    vp = torch.randn((n_pages, page, hkv, dh), generator=gen, device=dev)
    return kp.to(dt), vp.to(dt), None, None


def attn_tol(kind):
    # float32 pools: sum order; bf16 / int8 pools: the output is bf16 and
    # p is rounded to bf16 before PV (after a float32 softmax whose exp
    # differs from the plain version's in the last bit): two bf16 ulps.
    return (1e-5, 1e-5) if kind == "float32" else (2 ** -7, 2 ** -7)


def attn_parity(torch, dev):
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention,
        paged_prefill_attention,
    )
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref,
        paged_prefill_ref,
    )

    from repro_torch.kernels import _build

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    gen_deep = torch.Generator(device=dev).manual_seed(SEED + 12)
    b, hkv, g, dh, page, nblk, c = 8, 2, 8, 128, 16, 24, 32
    worst = {"decode": [0.0, 0.0], "prefill": [0.0, 0.0]}
    n_cases = {"decode": 0, "prefill": 0}
    routes = {}
    for kind in ("float32", "bfloat16", "int8"):
        kp, vp, ks, vs = attn_pools(torch, dev, gen, kind, b * nblk + 1,
                                    page, hkv, dh)
        bt = (1 + torch.randperm(b * nblk, generator=gen, device=dev)
              ).reshape(b, nblk).int()
        qdt = torch.float32 if kind == "float32" else torch.bfloat16
        rtol, atol = attn_tol(kind)
        for window in (0, 37):
            # decode: ragged last blocks, one lane at position 0, one full
            cur = torch.tensor([0, 15, 16, 33, 129, 250, 301,
                                page * nblk - 1], dtype=torch.int32,
                               device=dev)
            q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                            device=dev).to(qdt)
            y = paged_attention(q, kp, vp, bt, cur, window, ks, vs)
            r = paged_attention_ref(q, kp, vp, bt, cur, window, ks, vs)
            res = check_close("paged_decode_attention", y, r, rtol, atol,
                              kind=kind, window=window)
            worst["decode"] = [max(a, b) for a, b in zip(worst["decode"],
                                                          res)]
            n_cases["decode"] += 1
            # prefill: mid-page pos0, a ragged last lane, an idle lane
            # (lane 7); then every lane past 256 tokens of context (several
            # steps of the page walk), mid-page, the last lane ragged
            for pos0, seq_cut, idle in (
                    ([0, 7, 16, 45, 100, 201, 300, 120], 5, True),
                    ([257, 270, 300, 333, 290, 262, 345, 280], 9, False)):
                pos0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
                seq = pos0 + c
                seq[6] = pos0[6] + seq_cut
                if idle:
                    seq[7] = pos0[7]
                qp = torch.randn((b, c, hkv * g, dh),
                                 generator=gen if idle else gen_deep,
                                 device=dev).to(qdt)
                before = route_counts("paged_prefill_attention")
                y = paged_prefill_attention(qp, kp, vp, bt, pos0, seq,
                                            window, ks, vs)
                took = [name for name, n in
                        route_counts("paged_prefill_attention").items()
                        if n > before[name]]
                routes[kind] = took
                r = paged_prefill_ref(qp, kp, vp, bt, pos0, seq, window, ks,
                                      vs)
                # the idle lane's rows attend no key; the engine discards
                # them
                keep = 7 if idle else b
                res = check_close("paged_prefill_attention", y[:keep],
                                  r[:keep], rtol, atol, kind=kind,
                                  window=window, pos0=pos0.tolist())
                worst["prefill"] = [max(a, b) for a, b in
                                    zip(worst["prefill"], res)]
                n_cases["prefill"] += 1
    torch.cuda.synchronize()
    want = {"float32": ["cuda_core"], "bfloat16": ["tensor_core"],
            "int8": ["tensor_core"]}
    if routes != want:
        raise AssertionError(f"paged_prefill_attention routes {routes}")
    for name, (err, used) in worst.items():
        emit("parity", kernel=f"paged_{name}_attention",
             cases=n_cases[name],
             sweep="pools {float32,bfloat16,int8} x window {0,37}; G=8, "
                   "Dh=128, page 16, ragged last blocks, mid-page pos0"
                   + ("; pos0 0-300 and 257-345" if name == "prefill"
                      else ""),
             tolerance="float32: rtol=atol=1e-5; bf16 / int8 pools: "
                       "rtol=atol=2^-7", max_abs_err=err,
             max_share_of_tol=used,
             **({"routes": routes} if name == "prefill" else {}))


def decode_split_parity(torch, dev):
    """Paged decode attention's splits: a 4096-key table (64 splits of 64),
    lanes at position 0 (one split attended), mid-context and the last
    slot, windows 0 and 37; G 1 / 5 / 8 / 12 (one and two passes of 8
    heads), Dh 64 / 112 / 128, page 16 and 32, three pool types; every call
    twice, the same bits."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    b, hkv, keys = 4, 2, 4096
    worst, worst_used, n_cases = 0.0, 0.0, 0
    for kind in ("float32", "bfloat16", "int8"):
        qdt = torch.float32 if kind == "float32" else torch.bfloat16
        rtol, atol = attn_tol(kind)
        for page in (16, 32):
            nblk = keys // page
            for dh in (64, 112, 128):
                kp, vp, ks, vs = attn_pools(torch, dev, gen, kind,
                                            b * nblk + 1, page, hkv, dh)
                bt = (1 + torch.randperm(b * nblk, generator=gen,
                                         device=dev)).reshape(b, nblk).int()
                cur = torch.tensor([0, 1000, 2222, keys - 1],
                                   dtype=torch.int32, device=dev)
                for g in (1, 5, 8, 12):
                    q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                                    device=dev).to(qdt)
                    for window in (0, 37):
                        y = paged_attention(q, kp, vp, bt, cur, window, ks,
                                            vs)
                        if not torch.equal(y, paged_attention(
                                q, kp, vp, bt, cur, window, ks, vs)):
                            raise AssertionError(
                                f"paged_decode_attention {kind} G={g} "
                                f"Dh={dh}: two runs differ")
                        r = paged_attention_ref(q, kp, vp, bt, cur, window,
                                                ks, vs)
                        err, used = check_close(
                            "paged_decode_attention", y, r, rtol, atol,
                            kind=kind, page=page, dh=dh, g=g, window=window)
                        worst, worst_used = (max(worst, err),
                                             max(worst_used, used))
                        n_cases += 1
    torch.cuda.synchronize()
    emit("parity", kernel="paged_decode_attention", cases=n_cases,
         sweep="pools {float32,bfloat16,int8} x page {16,32} x Dh "
               "{64,112,128} x G {1,5,8,12} x window {0,37}; 4096-key "
               "table, lanes at 0, 1000, 2222, 4095; every call twice",
         tolerance="float32: rtol=atol=1e-5; bf16 / int8 pools: "
                   "rtol=atol=2^-7", max_abs_err=worst,
         max_share_of_tol=worst_used,
         launches=_build.LAUNCHES["paged_decode_attention"])


def _gathered(torch, kp, vp, ks, vs, bt):
    """The logical K/V view as bf16 ``(B, Hkv, T, Dh)``, dequantized for
    int8 pools: the input of the library yardstick."""
    from repro_torch.kernels.paged_attention.ref import gather_pages

    kg, vg = gather_pages(kp, bt), gather_pages(vp, bt)
    if ks is not None:
        kg = kg.float() * gather_pages(ks, bt).float()[..., None]
        vg = vg.float() * gather_pages(vs, bt).float()[..., None]
    dt = torch.float32 if kp.dtype == torch.float32 else torch.bfloat16
    return (kg.to(dt).transpose(1, 2).contiguous(),
            vg.to(dt).transpose(1, 2).contiguous())


def attn_time(torch, dev, kind, mode):
    """Kernel / plain / library times of one main-path attention call:
    8 lanes, G=8, Dh=128, page 16, contexts of 33-332 tokens."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.kernel import (
        paged_decode_attention_cuda,
        paged_prefill_attention_cuda,
        prefill_route,
    )
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref,
        paged_prefill_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    b, hkv, g, dh, page, c = 8, 2, 8, 128, 16, 32
    nblk = 1024 // page                  # the main path's max_len
    kp, vp, ks, vs = attn_pools(torch, dev, gen, kind, b * nblk + 1, page,
                                hkv, dh)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=dev)
          ).reshape(b, nblk).int()
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    eb = kp.element_size()
    t_pos = torch.arange(nblk * page, device=dev)
    if mode == "decode":
        cur = torch.tensor([40, 77, 129, 166, 200, 251, 300, 331],
                           dtype=torch.int32, device=dev)
        q = torch.randn((b, hkv, g, dh), generator=gen, device=dev).to(qdt)
        keys = int((cur + 1).sum())
        pairs = keys * hkv * g
        call = lambda kk, vv, kss, vss: paged_decode_attention_cuda(  # noqa
            q, kk, vv, bt, cur, 0, kss, vss)
        plain = lambda kk, vv, kss, vss: paged_attention_ref(  # noqa
            q.reshape(b, 1, hkv * g, dh), kk, vv, bt, cur, 0, kss, vss)
        out = call(kp, vp, ks, vs).reshape(b, 1, hkv * g, dh).to(qdt)
        ref = plain(kp, vp, ks, vs)
        mask = (t_pos[None, :] <= cur[:, None].long())[:, None, None, :]
        q_lib = q.reshape(b, hkv * g, 1, dh)
        q_bytes, o_bytes = q.numel() * q.element_size(), q.numel() * 4
    else:
        pos0 = torch.tensor([0, 32, 64, 100, 150, 200, 250, 268],
                            dtype=torch.int32, device=dev)
        seq = pos0 + c
        seq[-1] = pos0[-1] + 27          # a ragged last lane
        q = torch.randn((b, c, hkv, g, dh), generator=gen,
                        device=dev).to(qdt)
        keys = int(seq.sum())
        qpos = pos0[:, None].long() + torch.arange(c, device=dev)[None]
        valid_rows = qpos < seq[:, None]
        pairs = int(((qpos + 1) * valid_rows).sum()) * hkv * g
        call = lambda kk, vv, kss, vss: paged_prefill_attention_cuda(  # noqa
            q, kk, vv, bt, pos0, seq, 0, kss, vss)
        plain = lambda kk, vv, kss, vss: paged_prefill_ref(  # noqa
            q.reshape(b, c, hkv * g, dh), kk, vv, bt, pos0, seq, 0, kss, vss)
        out = call(kp, vp, ks, vs).reshape(b, c, hkv * g, dh).to(qdt)
        ref = plain(kp, vp, ks, vs)
        lim = torch.minimum(seq, pos0 + c).long()
        mask = ((t_pos[None, None, :] <= qpos[:, :, None])
                & (t_pos[None, None, :] < lim[:, None, None]))[:, None]
        q_lib = q.reshape(b, c, hkv * g, dh).transpose(1, 2).contiguous()
        q_bytes, o_bytes = q.numel() * q.element_size(), q.numel() * 4
        out, ref = out[valid_rows], ref[valid_rows]
    rtol, atol = attn_tol(kind)
    err, _ = check_close(f"paged_{mode}_attention", out, ref, rtol, atol,
                         kind=kind)
    kv_bytes = keys * hkv * dh * eb * 2
    if ks is not None:
        kv_bytes += keys * hkv * 2 * 2
    n_bytes = kv_bytes + q_bytes + o_bytes + bt.numel() * 4 + b * 8
    n_ops = 4 * pairs * dh
    bms, by = bound_ms(n_bytes, n_ops, "float32" if kind == "float32"
                       else "bfloat16")
    # rotate whole pools so the pages read across the run exceed L2
    copies = min(n_copies(kv_bytes), 128)
    pools = [(kp.clone(), vp.clone(),
              None if ks is None else ks.clone(),
              None if vs is None else vs.clone()) for _ in range(copies)]
    ms = timed_ms(call, pools, torch)
    plain_ms = timed_ms(plain, pools[:4], torch)
    del pools
    kg, vg = _gathered(torch, kp, vp, ks, vs, bt)
    views = [(kg.clone(), vg.clone()) for _ in range(min(copies, 8))]
    lib = timed_ms(lambda kk, vv: F.scaled_dot_product_attention(
        q_lib, kk, vv, attn_mask=mask, enable_gqa=True), views, torch)
    del views
    rec = dict(kernel=f"paged_{mode}_attention", pools=kind, lanes=b,
               chunk=c if mode == "prefill" else 1, keys=keys,
               **({"route": prefill_route(qdt, kp.dtype, dh, g)}
                  if mode == "prefill" else {}),
               max_abs_err=err, tol=dict(rtol=rtol, atol=atol), ms=ms,
               plain_ms=plain_ms, library_ms=lib,
               library="F.scaled_dot_product_attention over the gathered "
                       "bf16 view", bytes=n_bytes, ops=n_ops, bound_ms=bms,
               bound_by=by)
    emit("time", **rec)
    return rec


# ------------------------------------------- int8 bit-parallel kernel
def int8_tol(torch, q, scale, x, dt):
    """Per-element bound: a float32 sum of K products in two orders,
    within 16·√K·2^-24 of Σ|x|·|q|·scale (rounding errors of a K-term sum
    grow as √K; 16 covers their spread); a bfloat16 output adds one rounding
    of a sum that may differ in its last bits, one bf16 ulp (2^-7)."""
    s = (x.float().abs() @ q.float().abs()) * scale
    atol = 2.0 ** -20 * math.sqrt(q.shape[0]) * s
    return (0.0 if dt == torch.float32 else 2 ** -7), atol


def int8_case(torch, dev, gen, k, n, m, dt):
    from repro_torch.core import quantize_symmetric

    w = torch.randn((k, n), generator=gen, device=dev)
    q, scale = quantize_symmetric(w, 8)
    x = torch.randn((m, k), generator=gen, device=dev).to(dt)
    return q, scale, x


def int8_parity(torch, dev):
    from repro_torch.kernels import _build
    from repro_torch.kernels.int8_matvec.ops import int8_matvec
    from repro_torch.kernels.int8_matvec.ref import int8_matvec_ref

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    worst, worst_used, n_cases = 0.0, 0.0, 0
    cases = [((k, n), m, dt) for (k, n) in GEMV_SHAPES + [INT8_RAGGED]
             for m in (1, 3, 8, 256)
             for dt in (torch.float32, torch.bfloat16)]
    # ragged prefill M, K and N: the tensor-core route in bf16, the rows
    # route in float32 (at M = 100)
    cases += [((k, n), m, dt) for (k, n) in TC_RAGGED for m in TC_ROWS
              for dt in ((torch.float32, torch.bfloat16) if m < 1000
                         else (torch.bfloat16,))]
    for (k, n), m, dt in cases:
        q, scale, x = int8_case(torch, dev, gen, k, n, m, dt)
        y = int8_matvec(q, scale, x, out_dtype=dt)
        r = int8_matvec_ref(q, scale, x, out_dtype=dt)
        rtol, atol = int8_tol(torch, q, scale, x, dt)
        err, used = check_close("int8_matvec", y, r, rtol, atol, m=m, k=k,
                                n=n, dtype=str(dt))
        worst, worst_used = max(worst, err), max(worst_used, used)
        n_cases += 1
    torch.cuda.synchronize()
    routes = route_counts("int8_matvec")
    if not all(routes.values()):
        raise AssertionError(f"int8_matvec parity missed a route: {routes}")
    emit("parity", kernel="int8_matvec", cases=n_cases,
         sweep="M{1,3,8,256} x 4 qwen2.5-3b shapes + ragged K=2001, N=1003 "
               "x {float32,bfloat16} x and output; M{100,8192} x (K,N)"
               "{(520,300),(200,1983),(768,3352)} x bfloat16, float32 at "
               "M=100",
         tolerance="|y - ref| <= rtol*|ref| + 16*sqrt(K)*2^-24 * "
                   "(|x| @ |q|)*scale per element; rtol 0 for float32, "
                   "2^-7 (one ulp) for bfloat16 output",
         max_abs_err=worst, max_share_of_tol=worst_used, routes=routes)


def int8_time(torch, dev, m, k, n, dt=None):
    from repro_torch.kernels._gemv import decode_splits, route, sm_count
    from repro_torch.kernels.int8_matvec.kernel import int8_matvec_cuda
    from repro_torch.kernels.int8_matvec.ref import int8_matvec_ref

    dt = dt or torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 11 + m + k + n)
    q, scale, x = int8_case(torch, dev, gen, k, n, m, dt)
    y = int8_matvec_cuda(q, scale, x, out_dtype=dt)
    r = int8_matvec_ref(q, scale, x, out_dtype=dt)
    rtol, atol = int8_tol(torch, q, scale, x, dt)
    err, _ = check_close("int8_matvec", y, r, rtol, atol, m=m, k=k, n=n)
    xb = x.element_size()
    n_bytes = k * n + 4 * n + m * k * xb + m * n * xb
    n_ops = 2 * m * k * n
    dname = "bfloat16" if dt == torch.bfloat16 else "float32"
    bms, by = bound_ms(n_bytes, n_ops, dname)
    qs = [q.clone() for _ in range(n_copies(k * n))]
    ms = timed_ms(lambda qq: int8_matvec_cuda(qq, scale, x, out_dtype=dt),
                  [(qq,) for qq in qs], torch)
    plain = timed_ms(lambda qq: int8_matvec_ref(qq, scale, x, out_dtype=dt),
                     [(qq,) for qq in qs[:8]], torch)
    del qs
    w_deq = (q.float() * scale).to(dt)
    lib_copies = [w_deq.clone() for _ in
                  range(n_copies(w_deq.numel() * w_deq.element_size()))]
    lib = timed_ms(lambda w: torch.matmul(x, w), [(w,) for w in lib_copies],
                   torch)
    del lib_copies
    path = route(m, dt)
    rec = dict(kernel="int8_matvec", linear=GEMV_NAMES.get((k, n), ""), m=m,
               k=k, n=n, dtype=dname, gemv_route=path,
               **({"decode_splits": decode_splits(k, n, sm_count(dev))}
                  if path == "decode" else {}),
               earlier_ms=EARLIER_MS.get(("int8_matvec", m, k, n)),
               max_abs_err=err,
               tol=dict(rtol=rtol, atol_max=float(atol.max())), ms=ms,
               plain_ms=plain, library_ms=lib,
               library="torch.matmul on the dequantized bf16 weight",
               bytes=n_bytes, ops=n_ops, bound_ms=bms, bound_by=by)
    emit("time", **rec)
    return rec


# ------------------------------------------------- the engine's path
def engine_path(torch, dev):
    """The paper's engine path on the card; see the module docstring.

    Launches are read before the timing loops, so they count the path's
    own calls: one int8 launch and one bit-plane launch in the demo, and
    per dimension one int8 and two bit-plane (radix 1, 2) launches.
    """
    import numpy as np

    from repro_torch import paper_demo
    from repro_torch.core import QuantizedLinear, gemv, pack_weights
    from repro_torch.core.controller import run_gemv
    from repro_torch.core.isa import MAX_ELEMS
    from repro_torch.core.latency_model import IMAGINE_FSYS_MHZ
    from repro_torch.core.tile_array import u55_geometry
    from repro_torch.kernels import _build
    from repro_torch.kernels.int8_matvec import int8_matvec

    dims = ENGINE_DIMS + (u55_geometry().max_square_gemv(8),)
    torch.cuda.synchronize()
    _build.reset_launches()
    demo = paper_demo.run(96, device=dev)
    if demo["backend"] != "cuda":
        raise AssertionError(f"engine: demo resolved {demo['backend']}")
    cases = []
    for d in dims:
        rng = np.random.default_rng(SEED + d)
        r_max = (2 ** 24 - 1) // (d * 127)   # |partial sums| < 2^24
        w = rng.integers(-127, 128, size=(d, d))
        x = rng.integers(-r_max, r_max + 1, size=(d,))
        want = (w @ x).astype(np.float64)
        t0 = time.perf_counter()
        res = run_gemv(w, x, rows=16, cols=-(-d // MAX_ELEMS))
        model_s = time.perf_counter() - t0
        # the engine's weight is (K, N) with y = x @ W: the codes of w.T
        codes = torch.as_tensor(np.ascontiguousarray(w.T), dtype=torch.int8,
                                device=dev)
        ql = QuantizedLinear(pack_weights(codes, 8),
                             torch.ones((1, d), device=dev), 8, d, d)
        xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
        outs = {"tile_model": res.y.astype(np.float64),
                "bitplane_radix1": gemv(ql, xt, radix=1),
                "bitplane_radix2": gemv(ql, xt, radix=2),
                "int8_matvec": int8_matvec(ql.packed, ql.scale, xt)}
        for name, y in outs.items():
            if isinstance(y, torch.Tensor):
                y = y.double().cpu().numpy()
            if not np.array_equal(y, want):
                raise AssertionError(
                    f"engine d={d}: {name} differs from w @ x in "
                    f"{int((y != want).sum())} of {d} elements")
        cases.append(dict(d=d, r_max=r_max, ql=ql, xt=xt, res=res,
                          model_s=model_s))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    int8_routes = route_counts("int8_matvec")
    want_launches = {"int8_matvec": 1 + len(dims),
                     "bitplane_gemv": 1 + 2 * len(dims)}
    for kernel, n in want_launches.items():
        if launches[kernel] != n:
            raise AssertionError(f"engine: {kernel} launched "
                                 f"{launches[kernel]} times, expected {n}")
    rows = [dict(d=c["d"], r_max=c["r_max"], exact=True,
                 controller_cycles=c["res"].cycles,
                 controller_instrs=c["res"].instrs,
                 fpga_us_at_737mhz=c["res"].cycles / IMAGINE_FSYS_MHZ,
                 model_host_s=c["model_s"], **engine_times(torch, c))
            for c in cases]
    rec = dict(demo=dict(dim=demo["dim"], cycles=demo["cycles"],
                         fpga_us_at_737mhz=demo["exec_us"],
                         rel_err_bitplane=demo["rel_err_bitplane"],
                         rel_err_int8=demo["rel_err_int8"]),
               exact=rows, launches=launches, int8_routes=int8_routes)
    emit("engine", **rec)
    return rec


def engine_times(torch, case):
    """Card µs of the three kernels on one exact-GEMV case (M = 1, float32
    x and output) beside the bytes bound of the int8 weight."""
    from repro_torch.kernels.bitplane_gemv.kernel import bitplane_gemv_cuda
    from repro_torch.kernels.int8_matvec.kernel import int8_matvec_cuda

    d, ql, x = case["d"], case["ql"], case["xt"][None]
    n_bytes = d * d + 4 * d + 4 * d + 4 * d
    bms, by = bound_ms(n_bytes, 2 * d * d, "float32")
    packs = [(ql.packed.clone(),) for _ in range(n_copies(d * d))]
    card = {f"bitplane_radix{r}_us": 1e3 * timed_ms(
        lambda p, _r=r: bitplane_gemv_cuda(p, ql.scale, x, bits=8, radix=_r),
        packs, torch) for r in (1, 2)}
    card["int8_matvec_us"] = 1e3 * timed_ms(
        lambda p: int8_matvec_cuda(p, ql.scale, x), packs, torch)
    return dict(card_us=card, bytes=n_bytes, bound_us=1e3 * bms,
                bound_by=by)


# ----------------------------------------------------- serving phases
def full_config(**changes):
    from repro_torch.config import get_arch

    return dataclasses.replace(get_arch("qwen2.5-3b"), **changes)


def prompts_for(cfg, n, lo, hi, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1))
                         ).tolist() for _ in range(n)]


def build_engine(torch, dev, cfg, weight_bits, kv_bits, *, n_slots=8,
                 max_len=1024, max_new=32, params=None, mode="auto",
                 cuda_graphs=True, **engine_kw):
    from repro_torch.config import EngineConfig, ServeConfig
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    if params is None:
        # one layer at a time, packed as it is drawn: the dense bf16 tree
        # of the whole model never exists on the card
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, gen, engine_bits=weight_bits)
    scfg = ServeConfig(max_new_tokens=max_new,
                       engine=EngineConfig(weight_bits=weight_bits,
                                           kv_bits=kv_bits, **engine_kw),
                       page_size=16, prefill_chunk=32)
    eng = ServeEngine(cfg, params, scfg, n_slots=n_slots, max_len=max_len,
                      seed=SEED, mode=mode, cuda_graphs=cuda_graphs,
                      device=dev)
    return eng, params


def serve(torch, name, eng, prompts, max_new):
    """Submit, run to the end, check every request and report; returns
    the record and every request's tokens."""
    import numpy as np

    from repro_torch.kernels import _build

    reqs = [eng.submit(p) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    # the engine's own loop (``run``), one ``step`` at a time, with graph
    # replays counted through their capture's launches.  Paged mode: the
    # GEMV's tensor-core route must launch in exactly the steps that ran a
    # prefill chunk, its decode route in exactly those that ran a decode
    # step (each adds one entry to ``eng.timings``), and its rows route
    # never; the chunked prefill's tensor-core route once a layer in every
    # step that ran a chunk, its CUDA-core route never.  Slots mode: every
    # prompt token admitted and every decode step is one full-sequence
    # decode step, so the decode route launches a full step's GEMVs for
    # each, and no other route or attention kernel ever launches
    slots = eng.mode == "slots"
    per_step = (7 if eng.cfg.family == "dense" else 2) * eng.cfg.n_layers
    gemv_launches = {"prefill": 0, "decode": 0}
    attn_launches = 0
    t0 = time.perf_counter()
    done = []
    while eng.has_work():
        ran = {part: len(eng.timings[part]) for part in gemv_launches}
        if slots:
            free = sum(r is None for r in eng.slot_req)
            admitted = sum(len(r.prompt) for r in list(eng.queue)[:free])
        before = route_counts("bitplane_gemv")
        before_attn = route_counts("paged_prefill_attention")
        done.extend(eng.step())
        moved = {k: v - before[k]
                 for k, v in route_counts("bitplane_gemv").items()}
        moved_attn = {k: v - before_attn[k] for k, v in
                      route_counts("paged_prefill_attention").items()}
        ran = {part: len(eng.timings[part]) > n for part, n in ran.items()}
        if slots:
            want = per_step * (admitted + ran["decode"])
            if moved != {"decode": want, "rows": 0, "tensor_core": 0}:
                raise AssertionError(f"{name}: GEMV routes {moved} in a "
                                     f"step that ran {ran}, {admitted} "
                                     f"prompt tokens: wanted {want}")
            want_attn = 0
        else:
            if ((moved["tensor_core"] > 0) != ran["prefill"]
                    or (moved["decode"] > 0) != ran["decode"]
                    or moved["rows"]):
                raise AssertionError(f"{name}: GEMV routes {moved} in a "
                                     f"step that ran {ran}")
            want_attn = eng.cfg.n_layers * ran["prefill"]
        if moved_attn != {"cuda_core": 0, "tensor_core": want_attn}:
            raise AssertionError(f"{name}: prefill attention routes "
                                 f"{moved_attn} in a step that ran {ran}")
        gemv_launches["prefill"] += moved["tensor_core"]
        gemv_launches["decode"] += moved["decode"]
        attn_launches += moved_attn["tensor_core"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if len(done) != len(reqs):
        raise AssertionError(f"{name}: {len(done)} of {len(reqs)} finished")
    for r in reqs:
        if not r.done or len(r.output) != max_new:
            raise AssertionError(
                f"{name}: request {r.rid} done={r.done} with "
                f"{len(r.output)} tokens, wanted {max_new}")
        if not all(0 <= t < eng.cfg.vocab_size for t in r.output):
            raise AssertionError(f"{name}: token outside the vocabulary")
        # the engine raises on non-finite logits at every step; the last
        # ones are held here too
        if r.last_logits is None or not np.isfinite(r.last_logits).all():
            raise AssertionError(f"{name}: non-finite logits")
    n_tok = sum(len(r.output) for r in reqs)
    n_prompt = sum(len(p) for p in prompts)
    dec, pf = eng.timings["decode"], eng.timings["prefill"]
    rec = dict(
        model=eng.cfg.name, mode=eng.mode, cuda_graphs=eng.cuda_graphs,
        layers=eng.cfg.n_layers, d_model=eng.cfg.d_model,
        vocab=eng.cfg.vocab_size, weight_bits=eng.plan.bits,
        kv_bits=eng.plan.kv_bits, gemv_backend=eng.plan.backend,
        attn_backend=eng.attn_backend, slots=eng.n_slots,
        requests=len(reqs), prompt_tokens=n_prompt, new_tokens=n_tok,
        seconds=wall, tok_s=n_tok / wall, decode_steps=len(dec),
        decode_step_ms=1e3 * sum(dec) / max(len(dec), 1),
        # paged: one entry a prefill chunk; slots: one a prompt's
        # sequential prefill
        prefill_chunks=len(pf),
        prefill_chunk_ms=1e3 * sum(pf) / max(len(pf), 1),
        prefill_tok_s=n_prompt / max(sum(pf), 1e-12),
        capture_s=sum(eng.timings["capture"]),
        graphs_captured=len(eng.timings["capture"]),
        preemptions=eng.preemptions,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=launches, route_launches=dict(_build.ROUTE_LAUNCHES),
        gemv_tensor_core_launches=gemv_launches["prefill"],
        gemv_decode_launches=gemv_launches["decode"],
        prefill_attention_tensor_core_launches=attn_launches,
        prefill_attention_per_chunk=attn_launches / max(len(pf), 1))
    emit(name, **rec)
    kernels = ("bitplane_gemv",) if slots else PAGED_KERNELS
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched: {missing}")
    if not gemv_launches["decode"] or (not slots
                                       and not gemv_launches["prefill"]):
        raise AssertionError(f"{name}: GEMV launches {gemv_launches}")
    if eng.cuda_graphs and eng.timings["capture"] == []:
        raise AssertionError(f"{name}: no step was captured")
    return rec, [r.output for r in reqs]


def graphs_against_eager(torch, dev, name, cfg, weight_bits, kv_bits,
                         prompts, max_new, mode="auto", params=None,
                         graph_rec=None, graph_tokens=None, **kw):
    """The same prompts through an engine with CUDA graphs and one with
    ``cuda_graphs=False`` (given the graph run's record and tokens, only
    the eager one runs): greedy tokens must be identical, as the graphs
    replay the eager step's kernels on the same inputs.  Emits both runs'
    step times side by side."""
    runs = {}
    for graphs in (True, False):
        if graphs and graph_rec is not None:
            runs[graphs] = (graph_rec, graph_tokens)
            continue
        eng, params = build_engine(torch, dev, cfg, weight_bits, kv_bits,
                                   params=params, mode=mode,
                                   cuda_graphs=graphs, max_new=max_new, **kw)
        run = f"{name}_{'graphs' if graphs else 'eager'}"
        runs[graphs] = serve(torch, run, eng, prompts, max_new)
        del eng
        torch.cuda.empty_cache()
    (g, g_tok), (e, e_tok) = runs[True], runs[False]
    same = sum(a == b for a, b in zip(g_tok, e_tok))
    keys = ("tok_s", "decode_step_ms", "prefill_chunk_ms", "prefill_tok_s",
            "peak_mem_gib")
    emit(f"{name}_graphs_vs_eager", model=cfg.name, layers=cfg.n_layers,
         mode=g["mode"], requests=len(prompts), identical_requests=same,
         capture_s=g["capture_s"],
         **{f"{k}_graphs": g[k] for k in keys},
         **{f"{k}_eager": e[k] for k in keys},
         tok_s_ratio=g["tok_s"] / e["tok_s"],
         decode_step_ratio=e["decode_step_ms"] / g["decode_step_ms"])
    if same != len(prompts):
        raise AssertionError(f"{name}: graph and eager greedy tokens differ "
                             f"in {len(prompts) - same} requests")
    return params


def kernel_label(name: str) -> str:
    """A profiler kernel name without its namespace, return type and
    arguments: ``dec::decode_mma_kernel<4, 16>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0]


# the decode step's kernels of this port, by the labels' prefixes
DECODE_KERNELS = {"bitplane_gemv": ("dec::decode_",),
                  "paged_decode_attention": ("paged_decode_",)}


def _trace_windows(events, labels):
    """The device operations of each ``record_function`` window named in
    ``labels``: per window its length, operations, the port's decode
    kernels among them, their summed and their merged (busy) device ms;
    and over all windows the device ms and count of each operation by
    name."""
    from torch.autograd import DeviceType

    windows = {e.name: (e.time_range.start, e.time_range.end)
               for e in events if e.device_type == DeviceType.CPU
               and e.name in labels}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("chip_smoke.step.")]
    kept, by_name, launches = [], {}, {}
    for label in labels:
        lo_w, hi_w = windows[label]
        inside = [e for e in device if lo_w <= e.time_range.start
                  and e.time_range.end <= hi_w]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in inside)
        busy, edge = 0.0, -math.inf
        for lo, hi in spans:
            if hi > edge:
                busy += hi - max(lo, edge)
                edge = hi
        for e in inside:
            name = kernel_label(e.name)
            by_name[name] = by_name.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
            launches[name] = launches.get(name, 0) + 1
        ours = sum(kernel_label(e.name).startswith(prefixes)
                   for e in inside for prefixes in DECODE_KERNELS.values())
        kept.append(dict(window_ms=(hi_w - lo_w) / 1e3, ops=len(inside),
                         ours=ours, busy_ms=busy / 1e3,
                         device_ms=sum(hi - lo for lo, hi in spans) / 1e3))
    return kept, by_name, launches


def _trace_summary(kept, by_name, launches, top):
    n = len(kept)
    per = {name: ms / n for name, ms in by_name.items()}
    return per, dict(
        device_kernel_ms_per_step=sum(k["device_ms"] for k in kept) / n,
        kernels_per_step=sum(k["ops"] for k in kept) / n,
        device_busy_share=sum(k["busy_ms"] for k in kept)
        / sum(k["window_ms"] for k in kept),
        by_kernel=[dict(name=name, ms_per_step=ms,
                        launches_per_step=launches[name] / n)
                   for name, ms in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:top]])


def profile_decode_steps(torch, eng, prompts, n_steps=4, n_chunks=2):
    """Device time of ``n_steps`` paged decode steps (and of ``n_chunks``
    prefill chunks), by kernel, and the device's busy share of a step.

    Submits ``prompts`` to the engine and drives ``ServeEngine.step``
    inside one ``torch.profiler`` session, each step in its own
    ``record_function`` window that ends with a synchronize; keeps the
    first ``n_steps`` steps that ran a decode step and no prefill chunk,
    and the first ``n_chunks`` that ran a chunk and no decode step (on an
    engine whose graphs are captured: replays).  Reports per kept step the
    device milliseconds of every kernel (and copy) by name, their sum, and
    the busy share: the union of their intervals over the step's window.
    The profiler slows a step down, so the engine then runs dry
    unprofiled, with CUDA events around each call of its decode step:
    ``replay_ms`` is the device time of the step's graph (its kernels and
    the gaps between them), ``replay_share`` that time over the step's
    host wall time (from its start to a synchronize after it).  If the
    profiler records none of the port's decode kernels in a decode step
    (as when it cannot see inside a graph's replay), no kernel breakdown
    is given (``source``).
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    for p in prompts:
        eng.submit(p)

    def ran_parts(before):
        return tuple(len(eng.timings[part]) > before[part]
                     for part in ("prefill", "decode"))

    def counts():
        return {part: len(eng.timings[part]) for part in ("prefill",
                                                          "decode")}

    decode_labels, chunk_labels, n_profiled = [], [], 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while eng.has_work() and len(decode_labels) < n_steps:
            before = counts()
            torch.cuda.synchronize()
            label = f"chip_smoke.step.{n_profiled}"
            n_profiled += 1
            with record_function(label):
                eng.step()
                torch.cuda.synchronize()
            ran = ran_parts(before)
            if ran == (False, True):
                decode_labels.append(label)
            elif ran == (True, False) and len(chunk_labels) < n_chunks:
                chunk_labels.append(label)
    events = prof.events()
    kept, by_name, launches = _trace_windows(events, decode_labels)

    # unprofiled: CUDA events around each call of the decode step
    step_fn, replays = eng._decode_paged, []

    def timed_step():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn()
        end.record()
        replays.append((start, end))
        return out

    eng._decode_paged = timed_step
    plain = []
    try:
        while eng.has_work():
            before = counts()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if ran_parts(before) == (False, True):
                plain.append((1e3 * (time.perf_counter() - t0),
                              replays[-1][0].elapsed_time(replays[-1][1])))
    finally:
        eng._decode_paged = step_fn
    n = len(kept)
    if n == 0 or not plain:
        raise AssertionError("main profile: no decode-only step ran")
    have_trace = all(k["ours"] > 0 for k in kept)
    rec = dict(steps=n, source="torch.profiler" if have_trace
               else "cuda_events", cuda_graphs=eng.cuda_graphs,
               profiled_window_ms=[k["window_ms"] for k in kept],
               profiled_device_ops_per_step=[k["ops"] for k in kept],
               unprofiled_steps=len(plain),
               step_wall_ms=sum(w for w, _ in plain) / len(plain),
               replay_ms=sum(r for _, r in plain) / len(plain),
               replay_share=sum(r for _, r in plain)
               / sum(w for w, _ in plain))
    if have_trace:
        per, summary = _trace_summary(kept, by_name, launches, 20)
        rec.update(summary, port_kernels_ms_per_step={
            kernel: sum(ms for name, ms in per.items()
                        if name.startswith(prefixes))
            for kernel, prefixes in DECODE_KERNELS.items()})
        if chunk_labels:
            chunks = _trace_windows(events, chunk_labels)
            rec["prefill_chunk"] = dict(
                chunks=len(chunk_labels),
                window_ms=[k["window_ms"] for k in chunks[0]],
                **_trace_summary(*chunks, 12)[1])
    emit("main_profile", **rec)
    return rec


def whole_path_check(torch, dev):
    """Kernel engine vs plain-backend engine at 2 layers, full width.

    Greedy tokens must agree.  Both paths round activations to bf16, and a
    bf16 rounding of a sum added in another order may fall the other way,
    so where two candidate tokens are nearly tied the choice may
    legitimately differ: a request whose tokens differ passes only if, at
    its first difference, the plain path's top two logits lie within
    ``2 * logit_tol`` of each other (the comparison of that request stops
    there, as the two continuations differ).

    ``logit_tol``: the logits here stay below 8 in magnitude, where a bf16
    ulp is 2^-5; two layers of bf16 activations whose roundings may fall
    either way, then the bf16 rounding of each logit, stay within four
    such ulps.
    """
    import numpy as np

    logit_tol = 0.125
    cfg = full_config(n_layers=2)
    prompts = prompts_for(cfg, 8, 33, 300, SEED + 6)
    records = {}
    params = None
    for name, kw in (("cuda", {}),
                     ("plain", dict(backend="reference",
                                    attn_backend="gather"))):
        eng, params = build_engine(torch, dev, cfg, 4, 8, max_new=16,
                                   params=params, **kw)
        seen = {}
        sample = eng._sample_next

        def record(req, _sample=sample, _seen=seen):
            _seen.setdefault(req.rid, []).append(
                np.array(req.last_logits, dtype=np.float32))
            return _sample(req)

        eng._sample_next = record
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        records[name] = ([r.output for r in reqs], seen, eng)
    (tok_k, log_k, eng_k), (tok_p, log_p, eng_p) = (records["cuda"],
                                                    records["plain"])
    if (eng_k.plan.backend, eng_k.attn_backend) != ("cuda", "cuda") or (
            eng_p.plan.backend, eng_p.attn_backend) != ("reference",
                                                        "gather"):
        raise AssertionError("whole: engines did not resolve as asked")
    first_err = max(float(np.abs(log_k[i][0] - log_p[i][0]).max())
                    for i in log_p)
    if first_err > logit_tol:
        raise AssertionError(f"whole: first-step logits differ by "
                             f"{first_err} > {logit_tol}")
    identical, near_ties = 0, []
    for rid, (a, b) in enumerate(zip(tok_k, tok_p)):
        if a == b:
            identical += 1
            continue
        i = next(j for j in range(len(b)) if a[j] != b[j])
        top2 = np.sort(log_p[rid][i])[-2:]
        margin = float(top2[1] - top2[0])
        if margin > 2 * logit_tol:
            raise AssertionError(
                f"whole: request {rid} differs at token {i} where the plain "
                f"path's margin is {margin}")
        near_ties.append(dict(request=rid, token=i, margin=margin))
    emit("whole", layers=cfg.n_layers, requests=len(prompts),
         identical_requests=identical, near_tie_divergences=near_ties,
         first_step_logit_max_abs_err=first_err, logit_tol=logit_tol)


# ---------------------------------------------- full-sequence kernels
def flash_inputs(torch, dev, gen, dt, s=None, **shape):
    sh = {**FLASH_SHAPE, **shape}
    s = s or sh["s"]
    q = torch.randn((sh["b"], s, sh["hq"], sh["d"]), generator=gen,
                    device=dev).to(dt)
    k = torch.randn((sh["b"], s, sh["hkv"], sh["d"]), generator=gen,
                    device=dev).to(dt)
    v = torch.randn((sh["b"], s, sh["hkv"], sh["d"]), generator=gen,
                    device=dev).to(dt)
    return q, k, v


def flash_plain(q, k, v, window):
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2),
                               window=window).transpose(1, 2)


def flash_tol(torch, dt):
    # float32: sum order and 64-key online-softmax steps against one
    # softmax per row; bfloat16 output: one rounding of float32 values
    # that may differ in their last bits, one bf16 ulp (2^-7 of the value)
    return (1e-5, 1e-5) if dt == torch.float32 else (2 ** -7, 1e-5)


# flash_parity's cases beside FLASH_SHAPE: (dtype name, S, window, shape
# changes); bfloat16 takes the tensor-core route, float32 the CUDA-core one
FLASH_CASES = [("bfloat16", 4096, 0, {}), ("bfloat16", 4100, 0, {}),
               ("bfloat16", 4096, 1024, {}),
               ("bfloat16", 2048, 0, dict(hq=8, hkv=8, d=64)),
               ("bfloat16", 1000, 0, dict(hq=16, hkv=2, d=32)),
               ("bfloat16", 777, 1, dict(hq=4, hkv=4, d=128)),
               ("float32", 4096, 0, {}),
               # head dims the tiles take zero-padded: zamba2-7b's 112 and
               # the reduced configs' 16
               ("bfloat16", 4096, 0, dict(d=112)),
               ("bfloat16", 1000, 64, dict(hq=8, hkv=2, d=16)),
               ("float32", 2048, 0, dict(d=112)),
               ("float32", 1000, 0, dict(hq=8, hkv=2, d=16))]


def flash_parity(torch, dev):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_attention

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst, worst_used, cases = 0.0, 0.0, []
    for dname, s, window, shape in FLASH_CASES:
        dt = getattr(torch, dname)
        q, k, v = flash_inputs(torch, dev, gen, dt, s, **shape)
        before = route_counts("flash_attention")
        y = flash_attention(q, k, v, window=window)
        took = [r for r, n in route_counts("flash_attention").items()
                if n > before[r]]
        r = flash_plain(q, k, v, window)
        rtol, atol = flash_tol(torch, dt)
        err, used = check_close("flash_attention", y, r, rtol, atol, s=s,
                                window=window, dtype=dname, **shape)
        worst, worst_used = max(worst, err), max(worst_used, used)
        want = "cuda_core" if dt == torch.float32 else "tensor_core"
        if took != [want]:
            raise AssertionError(f"flash_attention {dname}: routes {took}")
        cases.append(dict(s=s, window=window, dtype=dname, route=want,
                          **{**{k_: FLASH_SHAPE[k_] for k_ in
                                ("hq", "hkv", "d")}, **shape},
                          max_abs_err=err, max_share_of_tol=used))
        del q, k, v, y, r
    torch.cuda.synchronize()
    emit("parity", kernel="flash_attention", cases=cases, batch=2,
         tolerance="float32: rtol=atol=1e-5; bfloat16: rtol 2^-7 (one "
                   "ulp), atol 1e-5", max_abs_err=worst,
         max_share_of_tol=worst_used, routes=route_counts("flash_attention"))


def flash_time(torch, dev):
    """Kernel / plain / library times of one prefill attention call:
    two 4096-token prompts, bf16, window 0."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda,
        route as flash_route,
    )

    sh = FLASH_SHAPE
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    q, k, v = flash_inputs(torch, dev, gen, dt)
    y = flash_attention_cuda(q, k, v)
    rtol, atol = flash_tol(torch, dt)
    err, _ = check_close("flash_attention", y, flash_plain(q, k, v, 0),
                         rtol, atol)
    eb = q.element_size()
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * eb
    pairs = sh["s"] * (sh["s"] + 1) // 2 * sh["b"] * sh["hq"]
    n_ops = 4 * sh["d"] * pairs
    bms, by = bound_ms(n_bytes, n_ops, "bfloat16")
    sets = [tuple(t.clone() for t in (q, k, v))
            for _ in range(n_copies(n_bytes))]
    ms = timed_ms(lambda a, b, c: flash_attention_cuda(a, b, c), sets, torch)
    plain_ms = timed_ms(lambda a, b, c: flash_plain(a, b, c, 0), sets[:3],
                        torch)
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in ts)
                for ts in sets]
    del sets
    lib = timed_ms(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True, enable_gqa=True), lib_sets, torch)
    del lib_sets
    rec = dict(kernel="flash_attention", **sh, window=0, dtype="bfloat16",
               route=flash_route(dt, sh["d"]),
               max_abs_err=err, tol=dict(rtol=rtol, atol=atol), ms=ms,
               plain_ms=plain_ms, library_ms=lib,
               library="F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True) on (B, H, S, D) copies",
               bytes=n_bytes, ops=n_ops, bound_ms=bms, bound_by=by)
    emit("time", **rec)
    return rec


def ssd_inputs(torch, dev, gen, b=None, s=None, h=None, n=None,
               dtype="bfloat16"):
    """Seeded SSD-scan inputs at the ssm shape (``SSD_SHAPE``) unless given:
    xdt, B and C in ``dtype``, la float32 <= 0."""
    sh = SSD_SHAPE
    b, s, h, n = (b or sh["b"], s or sh["s"], h or sh["h"],
                  n or sh["n"])
    dt = getattr(torch, dtype)
    xdt = (0.1 * torch.randn((b, s, h, sh["p"]), generator=gen,
                             device=dev)).to(dt)
    la = -0.2 * torch.rand((b, s, h), generator=gen, device=dev)
    b_in = torch.randn((b, s, n), generator=gen, device=dev).to(dt)
    c_in = torch.randn((b, s, n), generator=gen, device=dev).to(dt)
    return xdt, la, b_in, c_in


def ssd_tol(r):
    # chunked float32 sums and exponentials of float32 cumulative decays
    # against the float64 recurrence: 1e-4 of the largest output
    return 1e-4, 1e-4 * float(r.abs().max())


def ssd_parity(torch, dev):
    """``SSD_CASES`` through ``ops.ssd_scan`` against the float64
    recurrence, each call twice (the same bits)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan.kernel import kernel_chunk
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    worst, worst_used, cases = 0.0, 0.0, []
    for b, s, h, n, chunk, dtype in SSD_CASES:
        inputs = ssd_inputs(torch, dev, gen, b, s, h, n, dtype)
        ry, rh = ssd_scan_ref(*inputs)
        before = _build.LAUNCHES["ssd_scan"]
        y, hf = ssd_scan(*inputs, chunk=chunk)
        torch.cuda.synchronize()
        if _build.LAUNCHES["ssd_scan"] != before + 1:
            raise AssertionError("ssd_scan: the wrapper did not launch")
        again = ssd_scan(*inputs, chunk=chunk)
        torch.cuda.synchronize()
        if not (torch.equal(y, again[0]) and torch.equal(hf, again[1])):
            raise AssertionError(f"ssd_scan: two calls differ in their bits "
                                 f"(B={b}, S={s}, H={h}, N={n}, "
                                 f"chunk={chunk}, {dtype})")
        kc = kernel_chunk(chunk, s)
        case = dict(b=b, s=s, h=h, n=n, chunk=chunk, kernel_chunk=kc,
                    chunks=-(-s // kc), last_chunk=s - (-(-s // kc) - 1) * kc,
                    dtype=dtype)
        for name, out, ref in (("y", y, ry), ("h", hf, rh)):
            rtol, atol = ssd_tol(ref)
            err, used = check_close("ssd_scan", out, ref, rtol, atol,
                                    output=name, **case)
            worst, worst_used = max(worst, err), max(worst_used, used)
            case[f"max_abs_err_{name}"] = err
            case[f"share_of_tol_{name}"] = used
        cases.append(case)
    emit("parity", kernel="ssd_scan", cases=cases,
         tolerance="rtol 1e-4, atol 1e-4*max|ref| against the float64 "
                   "recurrence; every call twice, the same bits",
         max_abs_err=worst, max_share_of_tol=worst_used)


def ssd_time(torch, dev):
    """Kernel / plain times of one prefill SSD call (mamba2-130m heads,
    four 4096-token prompts, chunk 256), and its three kernels' device
    times.  No single PyTorch call computes the scan: library_ms is
    null."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    sh, chunk = SSD_SHAPE, 256
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    inputs = ssd_inputs(torch, dev, gen)
    y, _ = ssd_scan_cuda(*inputs, chunk=chunk)
    ry, _ = ssd_scan_ref(*inputs)
    rtol, atol = ssd_tol(ry)
    err, _ = check_close("ssd_scan", y, ry, rtol, atol)
    b, s, nh, p, n = sh["b"], sh["s"], sh["h"], sh["p"], sh["n"]
    n_bytes = (sum(t.numel() * t.element_size() for t in inputs)
               + 4 * (b * s * nh * p + b * nh * p * n))
    # the chunked algorithm at this chunk: C B^T under the diagonal once per
    # lane and chunk; per head the decayed intra product, the inter term
    # and the state update
    tri = chunk * (chunk + 1) // 2
    nc = s // chunk
    n_ops = b * nc * (2 * n * tri + nh * (tri + 2 * p * tri
                                          + 4 * chunk * n * p))
    bms, by = bound_ms(n_bytes, n_ops, "bfloat16")
    sets = [tuple(t.clone() for t in inputs)
            for _ in range(n_copies(n_bytes))]
    ms = timed_ms(lambda *a: ssd_scan_cuda(*a, chunk=chunk), sets, torch)
    plain_ms = timed_ms(lambda *a: ssd_scan_ref(*a), sets[:2], torch)
    # the three kernels of one call, device microseconds (torch.profiler)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for args in sets[:5]:
            ssd_scan_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
    kernel_us = {e.key.split("<")[0].split("::")[-1]:
                 e.device_time_total / e.count
                 for e in prof.key_averages() if e.device_time_total > 0}
    del sets
    rec = dict(kernel="ssd_scan", **sh, chunk=chunk, dtype="bfloat16",
               max_abs_err=err, tol=dict(rtol=rtol, atol=atol), ms=ms,
               earlier_ms=EARLIER_MS["ssd_scan"], kernel_us=kernel_us,
               plain_ms=plain_ms, library_ms=None,
               blocks=dict(chunk_states=nh * nc * b,
                           state_scan=p * n // 1024 * nh * b,
                           outputs=2 * nh * nc * b),
               bytes=n_bytes, ops=n_ops, bound_ms=bms, bound_by=by)
    emit("time", **rec)
    return rec


# ------------------------------------------------ full-sequence phases
def seeded_tokens(torch, dev, cfg, b, s, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(
        dev, torch.int32)


def run_sequence(torch, dev, name, cfg, params, tokens, n_decode, ecfg,
                 expect):
    """``init_cache`` + one-shot ``prefill`` + greedy ``decode_step`` s,
    the decode steps as replays of one CUDA graph (``serve.StepGraph``;
    the step time leaves its capture out); checks finite logits and the
    kernel launches, returns the record."""
    from repro_torch.kernels import _build
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.serve import StepGraph

    b, s = tokens.shape
    cache = init_cache(cfg, b, s + n_decode + 32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens}, cfg, cache, ecfg)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    pf_launches = dict(_build.LAUNCHES)
    pf_routes = route_counts("bitplane_gemv")
    pf_flash_routes = route_counts("flash_attention")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: non-finite prefill logits")
    _build.reset_launches()
    out = []
    # the graph's token buffer, refilled on the device after every step
    nxt = torch.argmax(logits[:, -1].float(), -1)[:, None].int()
    step = StepGraph(lambda: decode_step(params, cache, nxt, cfg, ecfg)[0])
    t0 = time.perf_counter()
    for _ in range(n_decode):
        out.append(nxt.clone())
        logits = step()
        nxt.copy_(torch.argmax(logits[:, -1].float(), -1)[:, None])
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0 - step.capture_seconds
    dec_launches = dict(_build.LAUNCHES)
    dec_routes = route_counts("bitplane_gemv")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: non-finite decode logits")
    toks = torch.cat(out, 1)
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{name}: token outside the vocabulary")
    rec = dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               batch=b, prompt_tokens=s, weight_bits=ecfg.weight_bits,
               prefill_s=t_prefill, prefill_tok_s=b * s / t_prefill,
               decode_steps=n_decode, decode_step_ms=1e3 * t_decode / n_decode,
               decode_tok_s=b * n_decode / t_decode,
               decode_capture_s=step.capture_seconds,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               prefill_launches=pf_launches, decode_launches=dec_launches,
               prefill_gemv_routes=pf_routes, decode_gemv_routes=dec_routes,
               prefill_flash_routes=pf_flash_routes)
    emit(name, **rec)
    for kernel, want in expect.items():
        if pf_launches[kernel] != want:
            raise AssertionError(f"{name}: {kernel} launched "
                                 f"{pf_launches[kernel]} times in prefill, "
                                 f"expected {want}")
    if pf_routes["tensor_core"] != expect["bitplane_gemv"]:
        raise AssertionError(f"{name}: prefill GEMV routes {pf_routes}")
    # bf16 activations: every flash launch on the tensor-core route
    if pf_flash_routes != {"cuda_core": 0, "tensor_core":
                           expect.get("flash_attention", 0)}:
        raise AssertionError(f"{name}: prefill flash attention routes "
                             f"{pf_flash_routes}")
    if dec_launches["bitplane_gemv"] == 0 or (
            dec_routes["decode"] != dec_launches["bitplane_gemv"]):
        raise AssertionError(f"{name}: decode GEMV routes {dec_routes}")
    return rec


def long_path(torch, dev):
    from repro_torch.config import EngineConfig
    from repro_torch.models import init_params

    cfg = full_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, engine_bits=4)
    tokens = seeded_tokens(torch, dev, cfg, 2, 4096, SEED + 7)
    # per prefill: one flash call per layer, seven GEMVs per layer
    return run_sequence(torch, dev, "long", cfg, params, tokens, 32,
                        EngineConfig(weight_bits=4),
                        {"flash_attention": cfg.n_layers,
                         "bitplane_gemv": 7 * cfg.n_layers})


def ssm_config(**changes):
    from repro_torch.config import get_arch

    return dataclasses.replace(get_arch("mamba2-130m"), **changes)


def ssm_path(torch, dev):
    from repro_torch.config import EngineConfig
    from repro_torch.models import init_params

    cfg = ssm_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, engine_bits=4)
    tokens = seeded_tokens(torch, dev, cfg, 4, 4096, SEED + 8)
    # per prefill: one SSD scan per layer, in_proj and out_proj per layer
    return run_sequence(torch, dev, "ssm", cfg, params, tokens, 32,
                        EngineConfig(weight_bits=4),
                        {"ssd_scan": cfg.n_layers,
                         "bitplane_gemv": 2 * cfg.n_layers})


def slots_path(torch, dev):
    """Slots-mode serving: full-width mamba2-130m (the ssm family's only
    serving mode) at ``weight_bits=4``, 8 slots, max_len 1024, 16 prompts
    of 33-300 tokens entering by sequential decode, 32 new tokens each,
    every step a replayed graph of the full-sequence ``decode_step``.  Then
    graph against eager at 2 layers, and qwen2.5-3b (``kv_bits=0``) cut to
    4 layers: the dense family's frozen-slot K/V rows on the card."""
    cfg = ssm_config()
    eng, _ = build_engine(torch, dev, cfg, 4, 0, mode="slots")
    rec, _ = serve(torch, "slots", eng, prompts_for(cfg, 16, 33, 300, SEED),
                   32)
    del eng
    torch.cuda.empty_cache()
    cut = ssm_config(n_layers=2)
    graphs_against_eager(torch, dev, "slots_ssm", cut, 4, 0,
                         prompts_for(cut, 8, 33, 100, SEED + 30), 32,
                         mode="slots")
    dense = full_config(n_layers=4)
    graphs_against_eager(torch, dev, "slots_dense", dense, 4, 0,
                         prompts_for(dense, 4, 17, 48, SEED + 31), 16,
                         mode="slots")
    torch.cuda.empty_cache()
    return rec


def greedy_run(torch, cfg, params, tokens, n_decode, ecfg, graphs=False):
    """Prefill + greedy decode, the decode steps eager or (``graphs``) as
    replays of one CUDA graph; returns (tokens (B, n), logits per step as
    float32 (B, V) each)."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.serve import StepGraph

    b, s = tokens.shape
    cache = init_cache(cfg, b, s + n_decode, device=tokens.device)
    logits, cache = prefill(params, {"tokens": tokens}, cfg, cache, ecfg)
    nxt = torch.empty((b, 1), dtype=torch.int32, device=tokens.device)

    def fn():
        return decode_step(params, cache, nxt, cfg, ecfg)[0]

    step = StepGraph(fn) if graphs else fn
    steps, out = [logits[:, -1].to(torch.float32, copy=True)], []
    for _ in range(n_decode):
        nxt.copy_(torch.argmax(steps[-1], -1)[:, None])
        out.append(nxt.clone())
        # a copy: the next replay overwrites the graph's logits
        steps.append(step()[:, -1].to(torch.float32, copy=True))
    torch.cuda.synchronize()
    return torch.cat(out, 1), steps


def check_tokens(name, tok_a, tok_b, steps_b, logit_tol):
    """Greedy streams agree, up to a near tie: where they first differ,
    the second path's top two logits lie within ``2 * logit_tol``."""
    identical, near_ties = 0, []
    for lane in range(tok_a.shape[0]):
        a, b = tok_a[lane].tolist(), tok_b[lane].tolist()
        if a == b:
            identical += 1
            continue
        i = next(j for j in range(len(b)) if a[j] != b[j])
        top2 = steps_b[i][lane].topk(2).values
        margin = float(top2[0] - top2[1])
        if margin > 2 * logit_tol:
            raise AssertionError(f"{name}: lane {lane} differs at token {i} "
                                 f"where the margin is {margin}")
        near_ties.append(dict(lane=lane, token=i, margin=margin))
    return identical, near_ties


def long_whole_check(torch, dev):
    """At 2 layers, full width, for qwen2.5-3b (two 4096-token prompts) and
    mamba2-130m (two 3840-token prompts, so prompt and continuation fill
    whole 256-step chunks):

    * kernel path (cuda GEMV, flash attention / SSD scan) against the plain
      path (``reference`` GEMV, ``gather``: plain ``attend_flash`` /
      ``ssd_chunked``): first-step logits within ``logit_tol``, greedy
      tokens equal up to near ties (as the ``whole`` phase holds them);
    * teacher forcing on the kernel path: ``forward`` over prompt and the
      generated tokens against the logits of ``prefill`` and each
      ``decode_step``, within ``logit_tol``.

    ``logit_tol``: the logits stay below 8 in magnitude, where a bf16 ulp is
    2^-5; two layers of bf16 activations whose roundings may fall either way
    (sums in other orders: flash vs cached decode attention, the GEMV's
    decode and prefill tilings, the SSD chunks vs the recurrence), then the
    bf16 rounding of each logit, stay within four such ulps.
    """
    from repro_torch.config import EngineConfig
    from repro_torch.models import forward, init_params

    logit_tol = 0.125
    for cfg, s, n_decode in ((full_config(n_layers=2), 4096, 32),
                             (ssm_config(n_layers=2), 3840, 256)):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, gen, engine_bits=4)
        tokens = seeded_tokens(torch, dev, cfg, 2, s, SEED + 9)
        kern = EngineConfig(weight_bits=4)
        plain = EngineConfig(weight_bits=4, backend="reference",
                             attn_backend="gather")
        tok_k, steps_k = greedy_run(torch, cfg, params, tokens, n_decode,
                                    kern, graphs=True)
        # the kernel path once more with every decode step eager: the
        # graph replays the same kernels, so the tokens are identical
        tok_e, steps_e = greedy_run(torch, cfg, params, tokens, n_decode,
                                    kern)
        if not torch.equal(tok_k, tok_e):
            raise AssertionError(f"long_whole {cfg.name}: graph and eager "
                                 "greedy tokens differ")
        graph_err = max(float((a - b).abs().max())
                        for a, b in zip(steps_k, steps_e))
        tok_p, steps_p = greedy_run(torch, cfg, params, tokens, n_decode,
                                    plain)
        first_err = float((steps_k[0] - steps_p[0]).abs().max())
        if first_err > logit_tol:
            raise AssertionError(f"long_whole {cfg.name}: first-step logits "
                                 f"differ by {first_err} > {logit_tol}")
        identical, near_ties = check_tokens(f"long_whole {cfg.name}", tok_k,
                                            tok_p, steps_p, logit_tol)
        full_tokens = torch.cat([tokens, tok_k], 1)
        logits, _ = forward(params, {"tokens": full_tokens}, cfg, kern)
        tf = logits[:, s - 1:].float()
        steps = torch.stack(steps_k, 1)
        tf_err = float((tf - steps).abs().max())
        if not bool(torch.isfinite(logits).all()) or tf_err > logit_tol:
            raise AssertionError(f"long_whole {cfg.name}: forward vs "
                                 f"prefill + decode logits differ by "
                                 f"{tf_err} > {logit_tol}")
        emit("long_whole", model=cfg.name, layers=cfg.n_layers,
             prompt_tokens=s, decode_steps=n_decode,
             identical_lanes=identical, near_tie_divergences=near_ties,
             graph_vs_eager_tokens_identical=True,
             graph_vs_eager_logit_max_abs_diff=graph_err,
             first_step_logit_max_abs_err=first_err,
             teacher_forcing_logit_max_abs_err=tf_err,
             logit_tol=logit_tol)
        del params, logits
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in
    torch.backends.cudnn.allow_tf32 = False         # full float32
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    with Phase("env"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        emit("env", python=sys.version.split()[0], torch=torch.__version__,
             cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), nvidia_smi=smi,
             peaks=dict(hbm_bytes_s=PEAK_HBM_BYTES_S, ops_s=PEAK_OPS_S))

    with Phase("build"):
        from repro_torch.kernels import _build

        info = _build.build()
        regs = [ln.split(":", 1)[-1].strip()
                for ln in str(info["log"]).splitlines()
                if "registers" in ln or ("spill" in ln
                                         and "0 bytes spill stores" not in ln)]
        emit("build", seconds=info["seconds"], library=str(info["path"]),
             log=str(_build.BUILD_DIR / "build.log"), ptxas=regs)

    with Phase("parity"):
        gemv_parity(torch, dev)
        attn_parity(torch, dev)
        decode_split_parity(torch, dev)
        flash_parity(torch, dev)
        ssd_parity(torch, dev)
        int8_parity(torch, dev)

    with Phase("time"):
        gemv_rows = [gemv_time(torch, dev, m, k, n)
                     for m in (8, 256) for (k, n) in GEMV_SHAPES]
        attn_rows = {(kind, mode): attn_time(torch, dev, kind, mode)
                     for kind in ("int8", "bfloat16")
                     for mode in ("decode", "prefill")}
        # the full-sequence decode steps' GEMVs: M = 2 (long), 4 (ssm)
        gemv_rows += [gemv_time(torch, dev, 2, k, n) for (k, n) in
                      GEMV_SHAPES]
        gemv_rows += [gemv_time(torch, dev, 4, k, n) for (k, n) in
                      SSM_GEMV_SHAPES]
        # the one-shot prefills' GEMVs: M = 2 x 4096 (long), 4 x 4096 (ssm)
        gemv_rows += [gemv_time(torch, dev, 8192, k, n)
                      for (k, n) in GEMV_SHAPES]
        for (k, n) in SSM_GEMV_SHAPES:
            gemv_time(torch, dev, 16384, k, n)
        flash_rec = flash_time(torch, dev)
        ssd_rec = ssd_time(torch, dev)
        # bit-serial at 8 (radix 1, 2) and 2 bits against the bit-parallel
        # baseline, beside the 4-bit rows above
        for bits, radix in ((8, 1), (8, 2), (2, 1)):
            for (k, n) in GEMV_SHAPES:
                gemv_time(torch, dev, 8, k, n, bits=bits, radix=radix)
        int8_rows = [int8_time(torch, dev, m, k, n)
                     for m in (1, 8, 256, 8192) for (k, n) in GEMV_SHAPES]

    with Phase("main"):
        cfg = full_config()
        prompts = prompts_for(cfg, 16, 33, 300, SEED)
        eng, params = build_engine(torch, dev, cfg, 4, 8)
        main_rec, main_tokens = serve(torch, "main", eng, prompts, 32)
        profile_rec = profile_decode_steps(
            torch, eng, prompts_for(cfg, 8, 33, 300, SEED + 20))
        del eng
        torch.cuda.empty_cache()
        # the same prompts once more with every step eager
        graphs_against_eager(torch, dev, "main", cfg, 4, 8, prompts, 32,
                             params=params, graph_rec=main_rec,
                             graph_tokens=main_tokens)
        del params
        torch.cuda.empty_cache()

    with Phase("second"):
        cfg = full_config(n_layers=4)
        eng, _ = build_engine(torch, dev, cfg, 8, 0)
        serve(torch, "second", eng, prompts_for(cfg, 16, 33, 300, SEED + 1),
              32)
        del eng
        torch.cuda.empty_cache()

    with Phase("whole"):
        whole_path_check(torch, dev)

    with Phase("long"):
        long_rec = long_path(torch, dev)
        torch.cuda.empty_cache()

    with Phase("ssm"):
        ssm_rec = ssm_path(torch, dev)
        torch.cuda.empty_cache()

    with Phase("long_whole"):
        long_whole_check(torch, dev)

    with Phase("slots"):
        slots_path(torch, dev)

    with Phase("engine"):
        engine_rec = engine_path(torch, dev)

    def row(rows, m):      # w_gate/w_up at M = m
        return next(r for r in rows
                    if r["m"] == m and (r["k"], r["n"]) == GEMV_SHAPES[2])

    # the tensor-core route of both GEMVs at the long prefill's and the
    # paged prefill chunk's M, with its launches on each kernel's own path:
    # the long prefill and main's prefill chunks for the bit-plane GEMV, the
    # engine path (M = 1, so none) for the int8 baseline
    tc_launches = {
        ("bitplane_gemv", 8192): (
            long_rec["prefill_gemv_routes"]["tensor_core"], "long prefill"),
        ("bitplane_gemv", 256): (main_rec["gemv_tensor_core_launches"],
                                 "main prefill chunks"),
        ("int8_matvec", 8192): (engine_rec["int8_routes"]["tensor_core"],
                                "engine"),
        ("int8_matvec", 256): (engine_rec["int8_routes"]["tensor_core"],
                               "engine")}
    prefill = {
        name: [dict(m=m, k=r["k"], n=r["n"], linear=r["linear"],
                    gemv_route=r["gemv_route"],
                    source="src/repro_torch/csrc/tc_gemm.cuh",
                    launches=tc_launches[name, m][0],
                    launches_in=tc_launches[name, m][1],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for m in (8192, 256) for r in (row(rows, m),)]
        for name, rows in (("bitplane_gemv", gemv_rows),
                           ("int8_matvec", int8_rows))}
    reps = {"bitplane_gemv": next(r for r in gemv_rows if r["m"] == 8
                                  and (r["k"], r["n"]) == GEMV_SHAPES[2]),
            "paged_decode_attention": attn_rows[("int8", "decode")],
            "paged_prefill_attention": attn_rows[("int8", "prefill")],
            "flash_attention": flash_rec, "ssd_scan": ssd_rec,
            "int8_matvec": next(r for r in int8_rows if r["m"] == 8
                                and (r["k"], r["n"]) == GEMV_SHAPES[2])}
    shapes = {"bitplane_gemv": "decode w_gate/w_up: M=8, K=2048, N=11008, "
                               "4-bit, bf16",
              "paged_decode_attention": "decode: 8 lanes, 41-332 keys, "
                                        "int8 pools, G=8, Dh=128, page 16",
              "paged_prefill_attention": "prefill chunk: 8 lanes x 32, "
                                         "int8 pools, G=8, Dh=128, page 16",
              "flash_attention": "prefill: B=2, S=4096, Hq=16, Hkv=2, "
                                 "D=128, bf16, causal",
              "ssd_scan": "prefill: B=4, S=4096, H=24, P=64, N=128, "
                          "chunk 256, bf16 inputs",
              "int8_matvec": "M=8, K=2048, N=11008, bf16 x and output"}
    # launches on each kernel's own path: paged serving (main) for the
    # first three, the one-shot prefills of long and ssm for flash and the
    # SSD scan, the engine path for the int8 baseline
    launches = dict(main_rec["launches"])
    launches["flash_attention"] = long_rec["prefill_launches"][
        "flash_attention"]
    launches["ssd_scan"] = ssm_rec["prefill_launches"]["ssd_scan"]
    launches["int8_matvec"] = engine_rec["launches"]["int8_matvec"]
    # the same paths' launches by route, for the kernels with routes
    path_routes = {
        "bitplane_gemv": route_counts("bitplane_gemv",
                                      main_rec["route_launches"]),
        "paged_prefill_attention": route_counts(
            "paged_prefill_attention", main_rec["route_launches"]),
        "flash_attention": long_rec["prefill_flash_routes"],
        "int8_matvec": engine_rec["int8_routes"]}
    kernels = []
    for name, meta in KERNELS.items():
        rep = reps[name]
        kernels.append(dict(
            name=name, **meta, launches=launches[name],
            max_abs_err=rep["max_abs_err"], ms=rep["ms"],
            plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            shape=shapes[name],
            **({"routes": path_routes[name]} if name in path_routes else {}),
            **({"timed_route": rep.get("route", rep.get("gemv_route"))}
               if "route" in rep or "gemv_route" in rep else {}),
            **({"ms_per_main_decode_step":
                profile_rec["port_kernels_ms_per_step"][name]}
               if name in profile_rec.get("port_kernels_ms_per_step", {})
               else {}),
            **({"prefill": prefill[name]} if name in prefill else {})))
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
