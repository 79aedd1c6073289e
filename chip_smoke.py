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
                tensors at its path's shapes, with the tolerance;
   ``time``     kernel, plain-version and PyTorch-library times at those
                shapes, with the bytes and operations each call needs and
                the least time the card could take for them; with the
                bit-plane GEMV at 8 (radix 1, 2), 4 and 2 bits beside the
                int8 bit-parallel baseline, the card's version of the
                paper's bit-serial against bit-parallel comparison.
4. ``main``     paged serving: ``ServeEngine`` on full-width qwen2.5-3b (36
                layers, bf16, ``EngineConfig(weight_bits=4, kv_bits=8)``):
                16 seeded prompts of 33-300 tokens, 32 new tokens each.
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
                ``decode_step`` s.
8. ``ssm``      the same for full-width mamba2-130m (24 layers,
                ``weight_bits=4``): four 4096-token prompts (SSD scan),
                32 decode steps.
9. ``long_whole`` at 2 layers, full width, both models: the kernel path
                against the plain path (same greedy tokens, first-step
                logits within tolerance), and ``forward`` over prompt and
                continuation against ``prefill`` + ``decode_step`` logits
                (teacher forcing).
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
                times.

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
# the engine phase's exact GEMVs: qwen2.5-3b's wq (K = N = 2048); the U55's
# largest resident 8-bit square GEMV is added at run time
ENGINE_DIMS = (2048,)


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


def gemv_parity(torch, dev):
    from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv
    from repro_torch.kernels.bitplane_gemv.ref import bitplane_gemv_ref

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst, worst_used, n_cases = 0.0, 0.0, 0
    for bits in (2, 4, 8):
        for radix in (1, 2, 4):
            if bits % radix:
                continue
            for (k, n) in GEMV_SHAPES:
                for m in (1, 8, 256):
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
                        worst = max(worst, err)
                        worst_used = max(worst_used, used)
                        n_cases += 1
    torch.cuda.synchronize()
    emit("parity", kernel="bitplane_gemv", cases=n_cases,
         sweep="bits{2,4,8} x radix{1,2,4} x M{1,8,256} x 4 shapes x "
               "{float32,bfloat16}",
         tolerance="float32: rtol 1e-5, atol 1e-5*max|ref|; bfloat16 "
                   "output: rtol 2^-7 (one ulp), atol 1e-5*max|ref|",
         max_abs_err=worst, max_share_of_tol=worst_used)


def gemv_time(torch, dev, m, k, n, bits=4, radix=1, dt=None):
    from repro_torch.core import unpack_weights
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

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    b, hkv, g, dh, page, nblk, c = 8, 2, 8, 128, 16, 24, 32
    worst = {"decode": [0.0, 0.0], "prefill": [0.0, 0.0]}
    n_cases = 0
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
            # prefill: mid-page pos0, a ragged last lane, an idle lane
            pos0 = torch.tensor([0, 7, 16, 45, 100, 201, 300, 120],
                                dtype=torch.int32, device=dev)
            seq = pos0 + c
            seq[6] = pos0[6] + 5
            seq[7] = pos0[7]
            qp = torch.randn((b, c, hkv * g, dh), generator=gen,
                             device=dev).to(qdt)
            y = paged_prefill_attention(qp, kp, vp, bt, pos0, seq, window,
                                        ks, vs)
            r = paged_prefill_ref(qp, kp, vp, bt, pos0, seq, window, ks, vs)
            # the idle lane's rows attend no key; the engine discards them
            res = check_close("paged_prefill_attention", y[:7], r[:7], rtol,
                              atol, kind=kind, window=window)
            worst["prefill"] = [max(a, b) for a, b in zip(worst["prefill"],
                                                           res)]
            n_cases += 2
    torch.cuda.synchronize()
    for name, (err, used) in worst.items():
        emit("parity", kernel=f"paged_{name}_attention", cases=n_cases // 2,
             sweep="pools {float32,bfloat16,int8} x window {0,37}; G=8, "
                   "Dh=128, page 16, ragged last blocks, mid-page pos0",
             tolerance="float32: rtol=atol=1e-5; bf16 / int8 pools: "
                       "rtol=atol=2^-7", max_abs_err=err,
             max_share_of_tol=used)


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
    from repro_torch.kernels.int8_matvec.ops import int8_matvec
    from repro_torch.kernels.int8_matvec.ref import int8_matvec_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    worst, worst_used, n_cases = 0.0, 0.0, 0
    for (k, n) in GEMV_SHAPES + [INT8_RAGGED]:
        for m in (1, 3, 8, 256):
            for dt in (torch.float32, torch.bfloat16):
                q, scale, x = int8_case(torch, dev, gen, k, n, m, dt)
                y = int8_matvec(q, scale, x, out_dtype=dt)
                r = int8_matvec_ref(q, scale, x, out_dtype=dt)
                rtol, atol = int8_tol(torch, q, scale, x, dt)
                err, used = check_close("int8_matvec", y, r, rtol, atol,
                                        m=m, k=k, n=n, dtype=str(dt))
                worst, worst_used = max(worst, err), max(worst_used, used)
                n_cases += 1
    torch.cuda.synchronize()
    emit("parity", kernel="int8_matvec", cases=n_cases,
         sweep="M{1,3,8,256} x 4 qwen2.5-3b shapes + ragged K=2001, N=1003 "
               "x {float32,bfloat16} x and output",
         tolerance="|y - ref| <= rtol*|ref| + 16*sqrt(K)*2^-24 * "
                   "(|x| @ |q|)*scale per element; rtol 0 for float32, "
                   "2^-7 (one ulp) for bfloat16 output",
         max_abs_err=worst, max_share_of_tol=worst_used)


def int8_time(torch, dev, m, k, n, dt=None):
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
    rec = dict(kernel="int8_matvec", linear=GEMV_NAMES.get((k, n), ""), m=m,
               k=k, n=n, dtype=dname, max_abs_err=err,
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
               exact=rows, launches=launches)
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
                 max_len=1024, max_new=32, params=None, **engine_kw):
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
                      seed=SEED, device=dev)
    return eng, params


def serve(torch, name, eng, prompts, max_new):
    """Submit, run to the end, check every request and report."""
    import numpy as np

    from repro_torch.kernels import _build

    reqs = [eng.submit(p) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
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
    dec, pf = eng.timings["decode"], eng.timings["prefill"]
    rec = dict(
        layers=eng.cfg.n_layers, d_model=eng.cfg.d_model,
        vocab=eng.cfg.vocab_size, weight_bits=eng.plan.bits,
        kv_bits=eng.plan.kv_bits, gemv_backend=eng.plan.backend,
        attn_backend=eng.attn_backend, requests=len(reqs),
        prompt_tokens=sum(len(p) for p in prompts), new_tokens=n_tok,
        seconds=wall, tok_s=n_tok / wall, decode_steps=len(dec),
        decode_step_ms=1e3 * sum(dec) / max(len(dec), 1),
        prefill_chunks=len(pf),
        prefill_chunk_ms=1e3 * sum(pf) / max(len(pf), 1),
        preemptions=eng.preemptions,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=launches)
    emit(name, **rec)
    missing = [k for k in PAGED_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched: {missing}")
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
def flash_inputs(torch, dev, gen, dt, s=None):
    sh = FLASH_SHAPE
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


def flash_parity(torch, dev):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst, worst_used, cases = 0.0, 0.0, []
    for dt, s, window in ((torch.bfloat16, 4096, 0),
                          (torch.bfloat16, 4100, 0),
                          (torch.bfloat16, 4096, 1024),
                          (torch.float32, 4096, 0)):
        q, k, v = flash_inputs(torch, dev, gen, dt, s)
        y = flash_attention(q, k, v, window=window)
        r = flash_plain(q, k, v, window)
        rtol, atol = flash_tol(torch, dt)
        err, used = check_close("flash_attention", y, r, rtol, atol, s=s,
                                window=window, dtype=str(dt))
        worst, worst_used = max(worst, err), max(worst_used, used)
        cases.append(dict(s=s, window=window, dtype=str(dt).split(".")[-1],
                          max_abs_err=err))
        del q, k, v, y, r
    torch.cuda.synchronize()
    emit("parity", kernel="flash_attention", cases=cases,
         shape="B=2, Hq=16, Hkv=2, D=128",
         tolerance="float32: rtol=atol=1e-5; bfloat16: rtol 2^-7 (one "
                   "ulp), atol 1e-5", max_abs_err=worst,
         max_share_of_tol=worst_used)


def flash_time(torch, dev):
    """Kernel / plain / library times of one prefill attention call:
    two 4096-token prompts, bf16, window 0."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda,
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
               max_abs_err=err, tol=dict(rtol=rtol, atol=atol), ms=ms,
               plain_ms=plain_ms, library_ms=lib,
               library="F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True) on (B, H, S, D) copies",
               bytes=n_bytes, ops=n_ops, bound_ms=bms, bound_by=by)
    emit("time", **rec)
    return rec


def ssd_inputs(torch, dev, gen):
    sh = SSD_SHAPE
    xdt = (0.1 * torch.randn((sh["b"], sh["s"], sh["h"], sh["p"]),
                             generator=gen, device=dev)).to(torch.bfloat16)
    la = -0.2 * torch.rand((sh["b"], sh["s"], sh["h"]), generator=gen,
                           device=dev)
    b_in = torch.randn((sh["b"], sh["s"], sh["n"]), generator=gen,
                       device=dev).to(torch.bfloat16)
    c_in = torch.randn((sh["b"], sh["s"], sh["n"]), generator=gen,
                       device=dev).to(torch.bfloat16)
    return xdt, la, b_in, c_in


def ssd_tol(r):
    # chunked float32 sums and exponentials of float32 cumulative decays
    # against the float64 recurrence: 1e-4 of the largest output
    return 1e-4, 1e-4 * float(r.abs().max())


def ssd_parity(torch, dev):
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    inputs = ssd_inputs(torch, dev, gen)
    ry, rh = ssd_scan_ref(*inputs)
    worst, worst_used, cases = 0.0, 0.0, []
    for chunk in (256, 128):
        y, h = ssd_scan(*inputs, chunk=chunk)
        for name, out, ref in (("y", y, ry), ("h", h, rh)):
            rtol, atol = ssd_tol(ref)
            err, used = check_close("ssd_scan", out, ref, rtol, atol,
                                    chunk=chunk, output=name)
            worst, worst_used = max(worst, err), max(worst_used, used)
            cases.append(dict(chunk=chunk, output=name, max_abs_err=err))
    torch.cuda.synchronize()
    emit("parity", kernel="ssd_scan", cases=cases,
         shape="B=4, S=4096, H=24, P=64, N=128, bf16 inputs",
         tolerance="rtol 1e-4, atol 1e-4*max|ref| against the float64 "
                   "recurrence", max_abs_err=worst,
         max_share_of_tol=worst_used)


def ssd_time(torch, dev):
    """Kernel / plain times of one prefill SSD call (mamba2-130m heads,
    four 4096-token prompts, chunk 256).  No single PyTorch call computes
    the scan: library_ms is null."""
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
    del sets
    rec = dict(kernel="ssd_scan", **sh, chunk=chunk, dtype="bfloat16",
               max_abs_err=err, tol=dict(rtol=rtol, atol=atol), ms=ms,
               plain_ms=plain_ms, library_ms=None,
               blocks=b * nh, bytes=n_bytes, ops=n_ops, bound_ms=bms,
               bound_by=by)
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
    """``init_cache`` + one-shot ``prefill`` + greedy ``decode_step`` s;
    checks finite logits and the kernel launches, returns the record."""
    from repro_torch.kernels import _build
    from repro_torch.models import decode_step, init_cache, prefill

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
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: non-finite prefill logits")
    _build.reset_launches()
    out = []
    nxt = torch.argmax(logits[:, -1].float(), -1)[:, None].int()
    t0 = time.perf_counter()
    for _ in range(n_decode):
        out.append(nxt)
        logits, cache = decode_step(params, cache, nxt, cfg, ecfg)
        nxt = torch.argmax(logits[:, -1].float(), -1)[:, None].int()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    dec_launches = dict(_build.LAUNCHES)
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
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               prefill_launches=pf_launches, decode_launches=dec_launches)
    emit(name, **rec)
    for kernel, want in expect.items():
        if pf_launches[kernel] != want:
            raise AssertionError(f"{name}: {kernel} launched "
                                 f"{pf_launches[kernel]} times in prefill, "
                                 f"expected {want}")
    if dec_launches["bitplane_gemv"] == 0:
        raise AssertionError(f"{name}: decode launched no GEMV")
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


def greedy_run(torch, cfg, params, tokens, n_decode, ecfg):
    """Prefill + greedy decode; returns (tokens (B, n), logits per step as
    float32 (B, V) each)."""
    from repro_torch.models import decode_step, init_cache, prefill

    b, s = tokens.shape
    cache = init_cache(cfg, b, s + n_decode, device=tokens.device)
    logits, cache = prefill(params, {"tokens": tokens}, cfg, cache, ecfg)
    steps, out = [logits[:, -1].float()], []
    for _ in range(n_decode):
        nxt = torch.argmax(steps[-1], -1)[:, None].int()
        out.append(nxt)
        logits, cache = decode_step(params, cache, nxt, cfg, ecfg)
        steps.append(logits[:, -1].float())
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
                                    kern)
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
        flash_parity(torch, dev)
        ssd_parity(torch, dev)
        int8_parity(torch, dev)

    with Phase("time"):
        gemv_rows = [gemv_time(torch, dev, m, k, n)
                     for m in (8, 256) for (k, n) in GEMV_SHAPES]
        attn_rows = {(kind, mode): attn_time(torch, dev, kind, mode)
                     for kind in ("int8", "bfloat16")
                     for mode in ("decode", "prefill")}
        # the one-shot prefills' GEMVs: M = 2 x 4096 (long), 4 x 4096 (ssm)
        for (k, n) in GEMV_SHAPES:
            gemv_time(torch, dev, 8192, k, n)
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
                     for m in (1, 8, 256) for (k, n) in GEMV_SHAPES]

    with Phase("main"):
        cfg = full_config()
        eng, _ = build_engine(torch, dev, cfg, 4, 8)
        main_rec = serve(torch, "main", eng,
                         prompts_for(cfg, 16, 33, 300, SEED), 32)
        del eng
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

    with Phase("engine"):
        engine_rec = engine_path(torch, dev)

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
    kernels = []
    for name, meta in KERNELS.items():
        rep = reps[name]
        kernels.append(dict(
            name=name, **meta, launches=launches[name],
            max_abs_err=rep["max_abs_err"], ms=rep["ms"],
            plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            shape=shapes[name]))
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
