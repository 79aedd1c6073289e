"""PyTorch port vs JAX: the full-sequence path — ``forward`` and the
slots-layout cache path ``init_cache`` / one-shot ``prefill`` /
``decode_step`` — for the dense family (reduced qwen2.5-3b) and the ssm
family (reduced mamba2-130m), in float32.

Both packages get the same weights: JAX ``init_params(cfg, PRNGKey(0))``,
packed by JAX at ``weight_bits=8``, handed to the port through numpy and
``repro_torch.weights.params_from_numpy``.  Each case runs below the flash
threshold and at a lowered one (both packages' ``FLASH_THRESHOLD`` patched
to 16, so a 32-token prompt takes ``attend_flash``), and on the port's two
sequence-mixer routes: ``gather`` (the plain chunked flash and SSD paths)
and ``cuda`` on CPU tensors, which goes through the kernels' ``ops``
wrappers and so their plain versions (``kernels/*/ref.py``).

Tolerance: logits and caches within rtol = atol = 1e-4 (float32 sums in
another order; the ``cuda`` route's SSD plain version is the exact float64
recurrence where JAX sums chunks in float32), greedy tokens identical.
The port's own invariants close the file: ``forward`` over prompt and
continuation equals ``prefill`` + ``decode_step`` under teacher forcing,
and ``prefill`` equals decoding the prompt token by token, as
``tests/test_decode_equivalence.py`` holds them in JAX.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jt
from repro.config.base import EngineConfig
from repro.models import decode_step, forward, init_cache, init_params
from repro.models.transformer import prefill, quantize_params

import repro_torch.config as tconfig
import repro_torch.models as tmodels
import repro_torch.models.transformer as tt
from repro_torch.engine import resolve_plan as t_resolve_plan
from repro_torch.weights import params_from_numpy

from conftest import reduced_f32
from test_torch_model import jax_params_to_numpy, torch_cfg

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen2.5-3b", "mamba2-130m"]
B, S, MAX_LEN, N_DECODE = 2, 32, 48, 6
ROUTES = [(4096, "gather"), (16, "gather"), (16, "cuda")]


@functools.lru_cache(maxsize=None)
def _jax_model(arch, weight_bits):
    cfg = reduced_f32(arch)
    params = init_params(cfg, jax.random.PRNGKey(0))
    eng = None
    if weight_bits:
        params = quantize_params(params, cfg, weight_bits)
        eng = EngineConfig(weight_bits=weight_bits, backend="reference")
    return cfg, params, eng


def _port_model(arch, weight_bits):
    cfg, params, _ = _jax_model(arch, weight_bits)
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    plan = t_resolve_plan(tconfig.EngineConfig(
        weight_bits=weight_bits, backend="reference"), device="cpu")
    return tcfg, tparams, plan


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _cache_np(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


@functools.lru_cache(maxsize=None)
def _jax_run(arch, weight_bits, threshold):
    """JAX forward logits, prefill logits and cache, then N_DECODE greedy
    decode steps' logits, tokens and final cache, with JAX's flash
    threshold at ``threshold``."""
    cfg, params, eng = _jax_model(arch, weight_bits)
    toks = _tokens(cfg, 1)
    with mock.patch.object(jt, "FLASH_THRESHOLD", threshold):
        fwd = jax.jit(functools.partial(forward, cfg=cfg, eng=eng,
                                        remat="none"))
        logits, aux = fwd(params, {"tokens": jnp.asarray(toks)})
        pf = jax.jit(functools.partial(prefill, cfg=cfg, eng=eng))
        cache = init_cache(cfg, B, MAX_LEN)
        pl, cache = pf(params, {"tokens": jnp.asarray(toks)}, cache=cache)
    out = dict(forward=np.asarray(logits), aux=float(aux),
               prefill=np.asarray(pl),
               prefill_cache=_cache_np(cache), decode=[], tokens=[])
    dec = jax.jit(functools.partial(decode_step, cfg=cfg, eng=eng))
    nxt = np.argmax(np.asarray(pl)[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(N_DECODE):
        out["tokens"].append(nxt)
        lg, cache = dec(params, cache, jnp.asarray(nxt))
        out["decode"].append(np.asarray(lg))
        nxt = np.argmax(np.asarray(lg)[:, -1], -1)[:, None].astype(np.int32)
    out["final_cache"] = _cache_np(cache)
    return out


def _assert_cache_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for key, ref in jcache.items():
        np.testing.assert_allclose(tcache[key].numpy(), ref, **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("threshold,route", ROUTES)
@pytest.mark.parametrize("weight_bits", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, weight_bits, threshold, route,
                             monkeypatch):
    ref = _jax_run(arch, weight_bits, threshold)
    tcfg, tparams, plan = _port_model(arch, weight_bits)
    monkeypatch.setattr(tt, "FLASH_THRESHOLD", threshold)
    toks = torch.from_numpy(_tokens(tcfg, 1))
    logits, aux = tmodels.forward(tparams, {"tokens": toks}, tcfg, plan,
                                  attn_backend=route)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref["forward"], **TOL)
    hidden, _ = tmodels.forward(tparams, {"tokens": toks}, tcfg, plan,
                                return_hidden=True, attn_backend=route)
    assert hidden.shape == (B, S, tcfg.d_model)


@pytest.mark.parametrize("threshold,route", ROUTES)
@pytest.mark.parametrize("weight_bits", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, weight_bits, threshold, route,
                                      monkeypatch):
    ref = _jax_run(arch, weight_bits, threshold)
    tcfg, tparams, plan = _port_model(arch, weight_bits)
    monkeypatch.setattr(tt, "FLASH_THRESHOLD", threshold)
    toks = torch.from_numpy(_tokens(tcfg, 1))
    cache = tmodels.init_cache(tcfg, B, MAX_LEN, device="cpu")
    logits, cache = tmodels.prefill(tparams, {"tokens": toks}, tcfg, cache,
                                    plan, attn_backend=route)
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], **TOL)
    _assert_cache_close(cache, ref["prefill_cache"])
    nxt = torch.argmax(logits[:, -1], -1)[:, None].int()
    for step in range(N_DECODE):
        np.testing.assert_array_equal(nxt.numpy(), ref["tokens"][step])
        logits, cache = tmodels.decode_step(tparams, cache, nxt, tcfg, plan,
                                            attn_backend=route)
        np.testing.assert_allclose(logits.numpy(), ref["decode"][step],
                                   **TOL)
        nxt = torch.argmax(logits[:, -1], -1)[:, None].int()
    _assert_cache_close(cache, ref["final_cache"])


def _port_f32(arch):
    return _port_model(arch, 0)[:2]


@pytest.mark.parametrize("threshold,route", ROUTES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, threshold, route, monkeypatch):
    """Teacher forcing: ``forward`` over prompt + continuation gives the
    logits of ``prefill`` on the prompt and then ``decode_step`` on each
    continuation token."""
    tcfg, tparams = _port_f32(arch)
    monkeypatch.setattr(tt, "FLASH_THRESHOLD", threshold)
    toks = torch.from_numpy(_tokens(tcfg, 2, (B, S + 16)))
    full, _ = tmodels.forward(tparams, {"tokens": toks}, tcfg,
                              attn_backend=route)
    cache = tmodels.init_cache(tcfg, B, S + 16, device="cpu")
    lg, cache = tmodels.prefill(tparams, {"tokens": toks[:, :S]}, tcfg,
                                cache, attn_backend=route)
    steps = [lg[:, 0]]
    for i in range(S, S + 15):
        lg, cache = tmodels.decode_step(tparams, cache, toks[:, i:i + 1],
                                        tcfg, attn_backend=route)
        steps.append(lg[:, 0])
    scale = float(full.abs().max())
    err = float((full[:, S - 1:S + 15] - torch.stack(steps, 1)).abs().max())
    assert err < 5e-4 * scale, (arch, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_sequential_decode(arch):
    """One-shot ``prefill`` of a prompt leaves the same logits and cache as
    decoding the prompt token by token from an empty cache."""
    tcfg, tparams = _port_f32(arch)
    toks = torch.from_numpy(_tokens(tcfg, 3, (B, 16)))
    cache_p = tmodels.init_cache(tcfg, B, 24, device="cpu")
    lp, cache_p = tmodels.prefill(tparams, {"tokens": toks}, tcfg, cache_p)
    cache_s = tmodels.init_cache(tcfg, B, 24, device="cpu")
    for i in range(16):
        ls, cache_s = tmodels.decode_step(tparams, cache_s, toks[:, i:i + 1],
                                          tcfg)
    torch.testing.assert_close(ls, lp, **TOL)
    nxt = torch.argmax(lp[:, -1], -1)[:, None]
    l1, _ = tmodels.decode_step(tparams, cache_p, nxt, tcfg)
    l2, _ = tmodels.decode_step(tparams, cache_s, nxt, tcfg)
    torch.testing.assert_close(l1, l2, **TOL)


def test_unported_cache_layouts_and_families_raise():
    """The int8 and unstacked slots layouts are decode-only, as in JAX:
    ``prefill`` refuses them (``tests/test_torch_cache_layouts.py`` decodes
    them); ``split_local`` on a config without windows is the uniform
    cache; the hybrid family has no int8 layout."""
    tcfg, tparams = _port_f32("qwen2.5-3b")
    prompt = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    for kw in (dict(kv_bits=8), dict(stacked=False)):
        cache = tmodels.init_cache(tcfg, 1, 8, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="decode-only"):
            tmodels.prefill(tparams, prompt, tcfg, cache)
    cache = tmodels.init_cache(tcfg, 1, 8, device="cpu", split_local=True)
    assert "k_global" not in cache and cache["k"].shape[2] == 8
    # every family runs the full-sequence path now: the hybrid family
    # (reduced zamba2, the port's own init) among them
    hybrid = tconfig.ModelConfig(**{**tconfig.get_reduced(
        "zamba2-7b").__dict__, "dtype": "float32"})
    hparams = tmodels.init_params(hybrid, torch.Generator().manual_seed(0))
    logits, _ = tmodels.forward(hparams, {"tokens": torch.zeros(
        (1, 16), dtype=torch.int32)}, hybrid)
    assert logits.shape == (1, 16, hybrid.vocab_size)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="no int8 layout"):
        tmodels.init_cache(hybrid, 1, 8, device="cpu", kv_bits=8)
    for kw in (dict(stacked=False), dict(stacked=False, split_local=True)):
        cache = tmodels.init_cache(hybrid, 1, 8, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="decode-only"):
            tmodels.prefill(hparams, prompt, hybrid, cache)
    cache = tmodels.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="exceed"):
        tmodels.prefill(tparams, {"tokens": torch.zeros((1, 9),
                                                        dtype=torch.int32)},
                        tcfg, cache)


def test_ssm_params_from_numpy_keep_float32_head_params():
    """``a_log``, ``dt_bias`` and ``d_skip`` stay float32 when the rest of
    the tree is cast, as the JAX package keeps them; ``in_proj`` and
    ``out_proj`` pack like every other linear."""
    cfg, params, _ = _jax_model("mamba2-130m", 0)
    tcfg = torch_cfg(cfg)
    tp = params_from_numpy(jax_params_to_numpy(params), tcfg, device="cpu",
                           dtype=torch.bfloat16)
    ssm = tp["layers"][1]["ssm"]
    for name in ("a_log", "dt_bias", "d_skip"):
        assert ssm[name].dtype == torch.float32, name
    assert ssm["conv_w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ssm["dt_bias"].numpy(),
                                  np.asarray(params["layers"]["ssm"]
                                             ["dt_bias"][1]))
    packed = tmodels.quantize_params(tp, tcfg, 4)
    for name in ("in_proj", "out_proj"):
        lin = packed["layers"][0]["ssm"][name]
        assert lin.bits == 4 and lin.packed.dtype == torch.int8


def test_port_init_params_ssm_shapes():
    cfg, params, _ = _jax_model("mamba2-130m", 0)
    tcfg = torch_cfg(cfg)
    tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(0))
    jl = params["layers"]["ssm"]
    for name, val in tp["layers"][0]["ssm"].items():
        ref = jl[name]["w"] if isinstance(val, dict) else jl[name]
        got = val["w"] if isinstance(val, dict) else val
        assert tuple(got.shape) == tuple(ref.shape[1:]), name
        assert str(got.dtype).split(".")[-1] == str(ref.dtype), name
    packed = tmodels.init_params(tcfg, torch.Generator().manual_seed(0),
                                 engine_bits=8)
    assert packed["layers"][2]["ssm"]["in_proj"].bits == 8


# --------------------------------------------------------------------------
# the dense configs of slice 11: starcoder2-15b (plain GELU MLP, tanh form
# as jax.nn.gelu's default), gemma3-27b (sliding windows, 5 local : 1
# global at full size; reduced: window 8, every third layer global) and
# mistral-large-123b; logits within TOL (rtol = atol = 1e-4, float32 sums
# in another order)
DENSE_ARCHS = ["starcoder2-15b", "gemma3-27b", "mistral-large-123b"]


def _gelu_qwen():
    return reduced_f32("qwen2.5-3b", mlp_gated=False)


@functools.lru_cache(maxsize=None)
def _jax_forward(cfg, weight_bits, local_gather=False, seed=1):
    params = init_params(cfg, jax.random.PRNGKey(0))
    eng = None
    if weight_bits:
        params = quantize_params(params, cfg, weight_bits)
        eng = EngineConfig(weight_bits=weight_bits, backend="reference")
    toks = _tokens(cfg, seed)
    fwd = jax.jit(functools.partial(forward, cfg=cfg, eng=eng, remat="none",
                                    local_gather=local_gather))
    logits, _ = fwd(params, {"tokens": jnp.asarray(toks)})
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    plan = t_resolve_plan(tconfig.EngineConfig(
        weight_bits=weight_bits, backend="reference"), device="cpu")
    return np.asarray(logits), toks, tcfg, tparams, plan


@pytest.mark.parametrize("which", ["starcoder2-15b", "qwen2.5-3b-gelu"])
def test_gelu_mlp_matches_jax(which):
    """The plain MLP's GELU is the tanh form on both sides: reduced
    starcoder2-15b and reduced qwen2.5-3b with ``mlp_gated=False``,
    tokens ``default_rng(1)`` of shape (2, 32), ``forward`` on ``gather``
    within 1e-4 (with the exact erf GELU the first differs by 8.7e-4)."""
    cfg = (reduced_f32("starcoder2-15b") if which == "starcoder2-15b"
           else _gelu_qwen())
    assert not cfg.mlp_gated
    ref, toks, tcfg, tparams, plan = _jax_forward(cfg, 0)
    assert "w_gate" not in tparams["layers"][0]["mlp"]
    logits, _ = tmodels.forward(tparams, {"tokens": torch.from_numpy(toks)},
                                tcfg, plan, attn_backend="gather")
    np.testing.assert_allclose(logits.numpy(), ref, **TOL)


@pytest.mark.parametrize("route", ["gather", "cuda"])
@pytest.mark.parametrize("weight_bits", [0, 8])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_configs_forward_match_jax(arch, weight_bits, route):
    cfg = reduced_f32(arch)
    ref, toks, tcfg, tparams, plan = _jax_forward(cfg, weight_bits)
    logits, _ = tmodels.forward(tparams, {"tokens": torch.from_numpy(toks)},
                                tcfg, plan, attn_backend=route)
    np.testing.assert_allclose(logits.numpy(), ref, **TOL)


@pytest.mark.parametrize("weight_bits", [0, 8])
def test_gemma3_local_gather_matches_jax(weight_bits):
    """``forward(local_gather=True)`` on reduced gemma3 (window 8, S = 32,
    a multiple of it): every local layer through
    :func:`attend_local_gather`, against JAX's unscanned loop, within TOL;
    and equal to the masked dense path within TOL, the same function."""
    cfg = reduced_f32("gemma3-27b")
    assert S % cfg.sliding_window == 0
    ref, toks, tcfg, tparams, plan = _jax_forward(cfg, weight_bits, True)
    batch = {"tokens": torch.from_numpy(toks)}
    with mock.patch.object(tt, "attend_local_gather",
                           wraps=tt.attend_local_gather) as spy:
        logits, _ = tmodels.forward(tparams, batch, tcfg, plan,
                                    attn_backend="gather", local_gather=True)
    local = sum(not tcfg.is_global_layer(i) for i in range(tcfg.n_layers))
    assert spy.call_count == local > 0
    np.testing.assert_allclose(logits.numpy(), ref, **TOL)
    dense_logits, _ = tmodels.forward(tparams, batch, tcfg, plan,
                                      attn_backend="gather")
    np.testing.assert_allclose(logits.numpy(), dense_logits.numpy(), **TOL)


def test_local_gather_needs_whole_windows():
    cfg = reduced_f32("gemma3-27b")
    _, toks, tcfg, tparams, plan = _jax_forward(cfg, 0)
    with pytest.raises(ValueError, match="multiple"):
        tmodels.forward(tparams, {"tokens": torch.from_numpy(toks[:, :30])},
                        tcfg, plan, local_gather=True)


def test_port_registry_holds_the_dense_configs():
    """Each config file of the port equals the JAX package's, published
    and reduced."""
    from repro.config import get_arch as j_get_arch, get_reduced as j_red

    for arch in DENSE_ARCHS:
        for mine, ref in ((tconfig.get_arch(arch), j_get_arch(arch)),
                          (tconfig.get_reduced(arch), j_red(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch


# ------------------------------------------------------------ moe family
MOE_ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]


@pytest.mark.parametrize("threshold,route", ROUTES)
@pytest.mark.parametrize("weight_bits", [0, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch, weight_bits, threshold, route,
                                 monkeypatch):
    """Reduced qwen3-moe and llama4-scout: ``forward`` logits within TOL
    and the router aux loss summed over layers within 1e-6 of JAX's."""
    ref = _jax_run(arch, weight_bits, threshold)
    tcfg, tparams, plan = _port_model(arch, weight_bits)
    monkeypatch.setattr(tt, "FLASH_THRESHOLD", threshold)
    toks = torch.from_numpy(_tokens(tcfg, 1))
    logits, aux = tmodels.forward(tparams, {"tokens": toks}, tcfg, plan,
                                  attn_backend=route)
    np.testing.assert_allclose(logits.numpy(), ref["forward"], **TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert abs(float(aux) - ref["aux"]) <= 1e-6


@pytest.mark.parametrize("weight_bits", [0, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_jax(arch, weight_bits):
    """One-shot ``prefill`` and greedy ``decode_step`` s of the moe family
    against JAX's: logits and caches within TOL, the same tokens."""
    ref = _jax_run(arch, weight_bits, 4096)
    tcfg, tparams, plan = _port_model(arch, weight_bits)
    toks = torch.from_numpy(_tokens(tcfg, 1))
    cache = tmodels.init_cache(tcfg, B, MAX_LEN, device="cpu")
    logits, cache = tmodels.prefill(tparams, {"tokens": toks}, tcfg, cache,
                                    plan)
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], **TOL)
    _assert_cache_close(cache, ref["prefill_cache"])
    nxt = torch.argmax(logits[:, -1], -1)[:, None].int()
    for step in range(N_DECODE):
        np.testing.assert_array_equal(nxt.numpy(), ref["tokens"][step])
        logits, cache = tmodels.decode_step(tparams, cache, nxt, tcfg, plan)
        np.testing.assert_allclose(logits.numpy(), ref["decode"][step],
                                   **TOL)
        nxt = torch.argmax(logits[:, -1], -1)[:, None].int()
    _assert_cache_close(cache, ref["final_cache"])


def test_port_registry_holds_the_moe_configs():
    """The port's moe config files equal the JAX package's, published and
    reduced, and the port's own init packs each expert stack as drawn."""
    from repro.config import get_arch as j_get_arch, get_reduced as j_red

    for arch in MOE_ARCHS:
        for mine, ref in ((tconfig.get_arch(arch), j_get_arch(arch)),
                          (tconfig.get_reduced(arch), j_red(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
        tcfg = tconfig.get_reduced(arch)
        tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(0),
                                 engine_bits=4)
        moe = tp["layers"][0]["moe"]
        assert moe["w_gate"].packed.shape == (
            tcfg.n_experts, tcfg.d_model // 2, tcfg.moe_d_ff)
        assert moe["w_down"].scale.shape == (tcfg.n_experts, 1,
                                             tcfg.d_model)
        assert "w" in moe["router"]
        assert ("shared" in moe) == bool(tcfg.n_shared_experts)
