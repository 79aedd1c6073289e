"""PyTorch port vs JAX: ``prefill_chunk`` and ``decode_step_paged`` logits
on the reduced qwen2.5-3b config in float32, over weight_bits {0, 4, 8} ×
kv_bits {0, 8}, with ragged chunks and an idle lane.

Both packages get the same weights: JAX ``init_params(cfg, PRNGKey(0))``,
packed by JAX where the engine packs, handed to the port through numpy and
``repro_torch.weights.params_from_numpy``.  The JAX side runs its
``gather`` attention and ``reference`` GEMV; the port runs its plain paths
on the CPU.

Tolerance with full-precision KV pages: rtol = atol = 1e-4, the one
``tests/test_serve_paged.py`` uses for chunked-prefill logits (float32 sums
taken in another order).  With int8 KV pages: rtol = atol = 1e-3.  Both
packages round ``p * s_v`` to bf16 after a float32 softmax, and XLA's
``exp`` and PyTorch's differ in the last bit for about one element in ten,
so a bf16 rounding can fall the other way: one bf16 ulp (2^-8 relative) of
one probability, which moved the logits by up to 2.5e-4 here.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import EngineConfig
from repro.engine import resolve_plan
from repro.models import decode_step_paged, init_params, prefill_chunk
from repro.models.transformer import quantize_params
from repro.serve import PageAllocator, init_kv_pages

import repro_torch.config as tconfig
import repro_torch.engine as tengine
import repro_torch.models as tmodels
import repro_torch.serve as tserve
from repro_torch.weights import params_from_numpy

from conftest import reduced_f32

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
KV8_TOL = dict(rtol=1e-3, atol=1e-3)


def jax_params_to_numpy(tree):
    """A JAX parameter tree as numpy leaves, engine-packed linears as
    ``{"packed", "scale", "bias", "bits"}`` dicts."""
    if isinstance(tree, dict):
        return {k: jax_params_to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "packed") and hasattr(tree, "bits"):
        return {"packed": np.asarray(tree.packed),
                "scale": np.asarray(tree.scale),
                "bias": None if tree.bias is None else np.asarray(tree.bias),
                "bits": int(tree.bits)}
    return np.asarray(tree)


def torch_cfg(cfg):
    """The port's ModelConfig built from the same fields."""
    return tconfig.ModelConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg = reduced_f32("qwen2.5-3b")
    return cfg, init_params(cfg, jax.random.PRNGKey(0))


def _setup(weight_bits, kv_bits):
    cfg, params = _jax_params()
    if weight_bits:
        params = quantize_params(params, cfg, weight_bits)
    ecfg = EngineConfig(weight_bits=weight_bits, kv_bits=kv_bits,
                        backend="reference", attn_backend="gather")
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    tecfg = tconfig.EngineConfig(weight_bits=weight_bits, kv_bits=kv_bits,
                                 backend="reference", attn_backend="gather")
    return (cfg, params, resolve_plan(ecfg),
            tcfg, tparams, tengine.resolve_plan(tecfg, device="cpu"))


@pytest.mark.parametrize("weight_bits,kv_bits",
                         [(w, k) for w in (0, 4, 8) for k in (0, 8)])
def test_prefill_and_decode_logits_match_jax(weight_bits, kv_bits):
    cfg, params, plan, tcfg, tparams, tplan = _setup(weight_bits, kv_bits)
    tol = KV8_TOL if kv_bits else TOL
    page, chunk, b, max_len = 4, 5, 3, 24
    n_pages = b * (max_len // page) + 1
    alloc = PageAllocator(n_pages, page, b, max_len)
    lens = [11, 7, 0]                     # lane 2 stays idle throughout
    for lane, n in enumerate(lens):
        if n:
            assert alloc.ensure(lane, n + 4)
    bt_np = alloc.block_tables.copy()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]

    jpages = init_kv_pages(cfg, n_pages, page, kv_bits=kv_bits)
    tpages = tserve.init_kv_pages(tcfg, n_pages, page, kv_bits=kv_bits,
                                  device="cpu")
    jpf = jax.jit(functools.partial(prefill_chunk, cfg=cfg, eng=plan,
                                    attn_backend="gather"))
    jdec = jax.jit(functools.partial(decode_step_paged, cfg=cfg, eng=plan,
                                     attn_backend="gather"))
    bt_j, bt_t = jnp.asarray(bt_np), torch.from_numpy(bt_np)

    done = np.zeros(b, np.int64)
    while any(done[i] < lens[i] for i in range(b)):   # ragged last chunks
        toks = np.zeros((b, chunk), np.int32)
        pos0, seq = done.astype(np.int32), done.astype(np.int32)
        for i in range(b):
            n = min(chunk, lens[i] - done[i])
            toks[i, :n] = prompts[i][done[i]:done[i] + n]
            seq[i] = done[i] + n
        jl, jpages = jpf(params, jpages, bt_j, jnp.asarray(toks),
                         jnp.asarray(pos0), jnp.asarray(seq))
        tl = tmodels.prefill_chunk(
            tparams, tpages, bt_t, torch.from_numpy(toks),
            torch.from_numpy(pos0), torch.from_numpy(seq), tcfg, tplan,
            attn_backend="gather")
        live = [i for i in range(b) if seq[i] > pos0[i]]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **tol)
        done = seq.astype(np.int64)

    pos = np.asarray(lens, np.int32)
    active = np.asarray([n > 0 for n in lens])
    for step in range(3):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jpages = jdec(params, jpages, bt_j, jnp.asarray(pos),
                          jnp.asarray(active), jnp.asarray(toks))
        tl = tmodels.decode_step_paged(
            tparams, tpages, bt_t, torch.from_numpy(pos),
            torch.from_numpy(active), torch.from_numpy(toks), tcfg, tplan,
            attn_backend="gather")
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], **tol)
        pos = pos + active


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_params_byte_identical(bits):
    """The port's own ``quantize_params`` on the converted float32 params
    packs the same bytes and scales as JAX's."""
    cfg, params = _jax_params()
    jq = jax_params_to_numpy(quantize_params(params, cfg, bits))
    tcfg = torch_cfg(cfg)
    tq = tmodels.quantize_params(
        params_from_numpy(jax_params_to_numpy(params), tcfg, device="cpu"),
        tcfg, bits)
    for layer in range(cfg.n_layers):
        for group, names in (("attn", ("wq", "wk", "wv", "wo")),
                             ("mlp", ("w_gate", "w_up", "w_down"))):
            for name in names:
                j = jq["layers"][group][name]
                t = tq["layers"][layer][group][name]
                assert t.bits == j["bits"] == bits
                np.testing.assert_array_equal(t.packed.numpy(),
                                              j["packed"][layer])
                np.testing.assert_array_equal(t.scale.numpy(),
                                              j["scale"][layer])


def test_params_from_numpy_unstacks_layers():
    cfg, params = _jax_params()
    tparams = params_from_numpy(jax_params_to_numpy(params), torch_cfg(cfg),
                                device="cpu")
    assert len(tparams["layers"]) == cfg.n_layers
    for layer in range(cfg.n_layers):
        np.testing.assert_array_equal(
            tparams["layers"][layer]["attn"]["wq"]["w"].numpy(),
            np.asarray(params["layers"]["attn"]["wq"]["w"][layer]))
    assert torch.equal(tparams["embed"],
                       torch.from_numpy(np.asarray(params["embed"])))


def test_port_init_params_shapes_and_packing():
    """The port's own initialisation (from a ``torch.Generator``) has the
    JAX tree's shapes, and ``engine_bits`` packs each layer as it is
    drawn."""
    cfg, params = _jax_params()
    tcfg = torch_cfg(cfg)
    gen = torch.Generator().manual_seed(0)
    tp = tmodels.init_params(tcfg, gen)
    assert tp["embed"].shape == params["embed"].shape
    for name in ("wq", "wk", "wv", "wo"):
        assert (tp["layers"][0]["attn"][name]["w"].shape
                == params["layers"]["attn"][name]["w"].shape[1:])
    packed = tmodels.init_params(tcfg, torch.Generator().manual_seed(0),
                                 engine_bits=4)
    lin = packed["layers"][1]["mlp"]["w_down"]
    assert isinstance(lin, tengine.PackedLinear) and lin.bits == 4
    assert lin.packed.shape == (cfg.d_ff // 2, cfg.d_model)
