"""PyTorch port vs JAX: the three decode-only slots-cache layouts of
``init_cache`` — ``kv_bits=8`` (int8 K/V, bf16 per-(token, head)
scales), ``stacked=False`` (tuples of per-layer tensors) and
``split_local=True`` (gemma3's window-sized local rings beside
full-length global K/V) — each decoded token by token from an empty
cache against JAX's ``decode_step``, as
``tests/test_decode_equivalence.py`` decodes them.

Both packages get the same weights (JAX ``init_params``, through numpy)
and the same seeded tokens (teacher forcing: every step feeds the same
token to both, so a near tie cannot part the streams).  Reduced configs
in float32.

The int8 layouts, stacked and unstacked, are held against JAX's
**unstacked** int8 cache: JAX's stacked branch calls its attention
without the scales (caveat (h) in ``ROADMAP.md``), which
``test_jax_stacked_int8_drops_its_scales`` records.

Tolerance: logits and full-precision caches within rtol = atol = 1e-4
(float32 sums in another order); the int8 layouts' logits within 1e-3
(``p * s_v`` rounds to bf16 after a softmax whose ``exp`` may differ in
the last bit, as for int8 pages in ``ROADMAP.md`` queue 3) and their
scales within one bf16 ulp.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as j_decode, init_cache as j_init_cache
from repro.models import init_params

import repro_torch.models as tmodels
from repro_torch.weights import params_from_numpy

from conftest import reduced_f32
from test_torch_model import jax_params_to_numpy, torch_cfg

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
INT8_TOL = dict(rtol=1e-3, atol=1e-3)
B, MAX_LEN = 2, 24


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg = (reduced_f32(arch, capacity_factor=8.0) if "moe" in arch
           else reduced_f32(arch))
    jp = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    return cfg, jp, tcfg, params_from_numpy(jax_params_to_numpy(jp), tcfg,
                                            device="cpu")


def _tokens(cfg, n, seed=0):
    shape = (B, n, cfg.n_codebooks) if cfg.family == "audio" else (B, n)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x)
                      and x.dtype == torch.bfloat16 else x, np.float32)


def _assert_caches_close(tcache, jcache, **tol):
    assert set(tcache) == set(jcache)
    for key, ref in jcache.items():
        got = tcache[key]
        if isinstance(ref, tuple):
            assert isinstance(got, tuple) and len(got) == len(ref), key
        else:
            got, ref = (got,), (ref,)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(_np(g), _np(r), **tol, err_msg=key)


def _decode_both(arch, n, jax_layout, port_layout, seed=0):
    """Teacher-forced decode of ``n`` seeded tokens from empty caches:
    (JAX logits per step, port logits per step, JAX cache, port cache)."""
    cfg, jp, tcfg, tp = _models(arch)
    toks = _tokens(cfg, n, seed)
    jc = j_init_cache(cfg, B, MAX_LEN, **jax_layout)
    tc = tmodels.init_cache(tcfg, B, MAX_LEN, device="cpu", **port_layout)
    step = jax.jit(functools.partial(j_decode, cfg=cfg))
    jl, tl = [], []
    for i in range(n):
        lg, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        jl.append(np.asarray(lg))
        lg, tc = tmodels.decode_step(tp, tc, torch.from_numpy(
            toks[:, i:i + 1]), tcfg)
        tl.append(lg.numpy())
    return jl, tl, jc, tc


UNSTACKED_ARCHS = ["qwen2.5-3b", "qwen3-moe-235b-a22b", "mamba2-130m",
                   "zamba2-7b", "musicgen-medium", "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", UNSTACKED_ARCHS)
def test_unstacked_matches_jax(arch):
    """Tuples of per-layer (per-site) tensors for every family: logits at
    every step and the final cache equal JAX's unstacked decode (its
    unrolled loop, ``_decode_ssm_unrolled`` for ssm / hybrid)."""
    jl, tl, jc, tc = _decode_both(arch, 12, dict(stacked=False),
                                  dict(stacked=False))
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t, j, **TOL)
    _assert_caches_close(tc, jc, **TOL)


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "musicgen-medium",
                                  "qwen3-moe-235b-a22b"])
def test_int8_matches_jax_unstacked_int8(arch, stacked):
    """``kv_bits=8``, stacked and unstacked, against JAX's unstacked int8
    decode: logits at every step, scales, and the dequantized K/V."""
    jl, tl, jc, tc = _decode_both(arch, 12, dict(kv_bits=8, stacked=False),
                                  dict(kv_bits=8, stacked=stacked))
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t, j, **INT8_TOL)
    assert tc["k"][0].dtype == torch.int8
    assert tc["k_scale"][0].dtype == torch.bfloat16
    for name in ("k", "v"):
        for layer in range(len(jc[name])):
            sc_t = tc[f"{name}_scale"][layer]
            sc_j = np.asarray(jc[f"{name}_scale"][layer], np.float32)
            np.testing.assert_allclose(_np(sc_t), sc_j, rtol=2 ** -8,
                                       atol=0)
            deq_t = _np(tc[name][layer]) * _np(sc_t)[..., None]
            deq_j = np.asarray(jc[name][layer], np.float32) * sc_j[..., None]
            # a code at a rounding tie may land one step away
            np.testing.assert_allclose(deq_t, deq_j, rtol=0,
                                       atol=float(sc_j.max()) + 1e-6)


def test_jax_stacked_int8_drops_its_scales():
    """Caveat (h): JAX's stacked int8 decode casts K/V to int8 without
    scales and never writes ``k_scale`` / ``v_scale``, so its logits part
    from the unstacked int8 decode's; the port's stacked int8 cache keeps
    its scales and the unstacked logits."""
    cfg, jp, tcfg, tp = _models("qwen2.5-3b")
    jl_s, _, jc_s, _ = _decode_both("qwen2.5-3b", 6, dict(kv_bits=8), {})
    jl_u, tl_s, _, tc_s = _decode_both("qwen2.5-3b", 6,
                                       dict(kv_bits=8, stacked=False),
                                       dict(kv_bits=8))
    assert not np.asarray(jc_s["k_scale"], np.float32).any()
    assert not np.asarray(jc_s["v_scale"], np.float32).any()
    assert float(tc_s["k_scale"].float().abs().min(-1).values[:, :, :6]
                 .min()) > 0
    gap = max(float(np.abs(a - b).max()) for a, b in zip(jl_s, jl_u))
    assert gap > 1e-2
    for j, t in zip(jl_u, tl_s):
        np.testing.assert_allclose(t, j, **INT8_TOL)


@pytest.mark.parametrize("stacked", [True, False])
def test_split_local_matches_jax(stacked):
    """gemma3 (reduced: window 8, one global layer in three) decoded past
    its window: the split cache's logits and rings equal JAX's split
    decode, and the uniform cache's logits."""
    layout = dict(split_local=True, stacked=stacked)
    n = MAX_LEN
    jl, tl, jc, tc = _decode_both("gemma3-27b", n, layout, layout)
    cfg = _models("gemma3-27b")[0]
    ring = tc["k_local"][0]
    assert ring.shape[1] == cfg.sliding_window < n
    assert isinstance(tc["k_local"], tuple) != stacked
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t, j, **TOL)
    _assert_caches_close(tc, jc, **TOL)
    _, ul, _, _ = _decode_both("gemma3-27b", n, {}, {})
    for u, t in zip(ul, tl):
        np.testing.assert_allclose(t, u, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch,layout", [
    ("qwen2.5-3b", dict(kv_bits=8)), ("qwen2.5-3b", dict(stacked=False)),
    ("qwen2.5-3b", dict(kv_bits=8, stacked=False)),
    ("mamba2-130m", dict(stacked=False)), ("zamba2-7b", dict(stacked=False)),
    ("gemma3-27b", dict(split_local=True)),
    ("gemma3-27b", dict(split_local=True, stacked=False))])
def test_init_cache_layout_equals_jax(arch, layout):
    cfg, _, tcfg, _ = _models(arch)
    jc = j_init_cache(cfg, B, MAX_LEN, **layout)
    tc = tmodels.init_cache(tcfg, B, MAX_LEN, device="cpu", **layout)
    assert set(tc) == set(jc)
    for key, ref in jc.items():
        got = tc[key]
        assert isinstance(got, tuple) == isinstance(ref, tuple), key
        for g, r in (zip(got, ref) if isinstance(ref, tuple)
                     else [(got, ref)]):
            assert tuple(g.shape) == tuple(r.shape), key
            assert str(g.dtype).removeprefix("torch.") == str(r.dtype), key


@pytest.mark.parametrize("arch,layout", [
    ("qwen2.5-3b", dict(kv_bits=8)), ("qwen2.5-3b", dict(stacked=False)),
    ("mamba2-130m", dict(stacked=False)), ("zamba2-7b", dict(stacked=False)),
    ("gemma3-27b", dict(split_local=True))])
def test_prefill_refuses_the_decode_only_layouts(arch, layout):
    _, _, tcfg, tp = _models(arch)
    cache = tmodels.init_cache(tcfg, B, MAX_LEN, device="cpu", **layout)
    with pytest.raises(NotImplementedError, match="decode-only"):
        tmodels.prefill(tp, {"tokens": torch.zeros((B, 4), dtype=torch.int32)},
                        tcfg, cache)


def test_int8_refused_where_jax_has_no_scales():
    for arch, kw in (("mamba2-130m", {}), ("zamba2-7b", {}),
                     ("gemma3-27b", dict(split_local=True))):
        with pytest.raises(ValueError, match="no int8 layout"):
            tmodels.init_cache(_models(arch)[2], B, MAX_LEN, kv_bits=8,
                               device="cpu", **kw)


@pytest.mark.parametrize("layout", [dict(kv_bits=8, stacked=False),
                                    dict(split_local=True),
                                    dict(stacked=False)])
def test_frozen_lanes_stay_bit_identical(layout):
    """``active`` on the new layouts: a lane outside it keeps every cache
    entry and its position bit-identical while the other lane advances."""
    arch = "gemma3-27b" if "split_local" in layout else "qwen2.5-3b"
    cfg, _, tcfg, tp = _models(arch)
    toks = torch.from_numpy(_tokens(cfg, 10))
    cache = tmodels.init_cache(tcfg, B, MAX_LEN, device="cpu", **layout)
    for i in range(9):
        tmodels.decode_step(tp, cache, toks[:, i:i + 1], tcfg)
    before = {k: [t.clone() for t in (v if isinstance(v, tuple) else
                                      (v,))] for k, v in cache.items()}
    active = torch.tensor([True, False])
    tmodels.decode_step(tp, cache, toks[:, 9:10], tcfg, active=active)
    assert cache["pos"].tolist() == [10, 9]
    for key, old in before.items():
        per_layer = isinstance(cache[key], tuple)
        new = cache[key] if per_layer else (cache[key],)
        # lanes lead a per-layer tensor and ``pos``; a stacked one has
        # its layers first
        lane = 1 if per_layer or key == "pos" else (slice(None), 1)
        for o, t in zip(old, new):
            assert torch.equal(t[lane], o[lane]), key
