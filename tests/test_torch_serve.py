"""PyTorch port vs JAX: greedy paged serving end to end.

The port's ``ServeEngine`` on the CPU (plain GEMV and ``gather`` attention)
against JAX ``ServeEngine(mode="paged", attn_backend="gather")``, mirroring
``tests/test_serve_paged.py``: more requests than lanes, a page pool small
enough to force recompute preemption, int8 KV pages and engine-packed
weights.  Both engines get the same weights (JAX ``init_params`` through
``params_from_numpy``) and quantize them at construction.

Greedy tokens must be equal.  With int8 KV pages the final logits of each
request are compared too, at the tolerance of ``tests/test_torch_model.py``
(a bf16 rounding of ``p * s_v`` can fall the other way between the two
frameworks), so a token flipped by a near tie would show as a logit gap.
"""

import jax
import numpy as np
import pytest
import torch

from repro.config.base import EngineConfig as JaxEngineConfig
from repro.config.base import ServeConfig as JaxServeConfig
from repro.models import init_params
from repro.serve import ServeEngine as JaxServeEngine

import repro_torch.config as tconfig
from repro_torch.serve import ServeEngine
from repro_torch.weights import params_from_numpy

from conftest import reduced_f32
from test_torch_model import KV8_TOL, jax_params_to_numpy, torch_cfg

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10]]


@pytest.fixture(scope="module")
def model():
    cfg = reduced_f32("qwen2.5-3b")
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    return cfg, params, tcfg, tparams


def _serve_both(model, *, weight_bits=0, kv_bits=0, max_new=5, n_slots=2,
                max_len=32, prompts=PROMPTS, port_attn="gather", **kw):
    cfg, params, tcfg, tparams = model
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            ecfg = JaxEngineConfig(weight_bits=weight_bits, kv_bits=kv_bits,
                                   backend="reference")
            eng = JaxServeEngine(
                cfg, params, JaxServeConfig(max_new_tokens=max_new,
                                            engine=ecfg),
                n_slots=n_slots, max_len=max_len, mode="paged",
                attn_backend="gather", **kw)
        else:
            ecfg = tconfig.EngineConfig(weight_bits=weight_bits,
                                        kv_bits=kv_bits)
            eng = ServeEngine(
                tcfg, tparams, tconfig.ServeConfig(max_new_tokens=max_new,
                                                   engine=ecfg),
                n_slots=n_slots, max_len=max_len, attn_backend=port_attn,
                device="cpu", **kw)
        for p in prompts:
            eng.submit(p)
        done = sorted(eng.run(), key=lambda r: r.rid)
        assert len(done) == len(prompts)
        assert all(r.done and len(r.output) == max_new for r in done)
        out.append((eng, done))
    return out


def test_tokens_match_jax_more_requests_than_lanes(model):
    (_, jreq), (eng, treq) = _serve_both(model, page_size=4,
                                         prefill_chunk=3)
    assert eng.plan is None and eng.attn_backend == "gather"
    for j, t in zip(jreq, treq):
        assert j.output == t.output, (j.rid, j.output, t.output)


@pytest.mark.parametrize("n_slots,chunk", [(1, 2), (3, 5)])
def test_tokens_match_jax_across_geometry(model, n_slots, chunk):
    (_, jreq), (_, treq) = _serve_both(model, n_slots=n_slots, max_new=6,
                                       page_size=4, prefill_chunk=chunk)
    for j, t in zip(jreq, treq):
        assert j.output == t.output, (n_slots, chunk, j.rid)


def test_preemption_tokens_match_jax(model):
    """A pool too small for all residents forces recompute preemption of
    the longest-running request in both engines, at the same steps."""
    (jeng, jreq), (teng, treq) = _serve_both(
        model, n_slots=3, max_len=48, max_new=16, page_size=4, n_pages=14,
        prefill_chunk=4)
    assert teng.preemptions > 0
    assert teng.preemptions == jeng.sched.preemptions
    assert [r.preemptions for r in treq] == [r.preemptions for r in jreq]
    for j, t in zip(jreq, treq):
        assert j.output == t.output, (j.rid, j.output, t.output)


@pytest.mark.parametrize("weight_bits", [0, 8])
def test_kv8_tokens_and_logits_match_jax(model, weight_bits):
    (_, jreq), (eng, treq) = _serve_both(
        model, weight_bits=weight_bits, kv_bits=8, max_new=8, page_size=4,
        prefill_chunk=3)
    assert eng.pages.quantized and eng.pages.k.dtype == torch.int8
    assert eng.plan.kv_bits == 8 and eng.plan.bits == weight_bits
    for j, t in zip(jreq, treq):
        np.testing.assert_allclose(t.last_logits, np.asarray(j.last_logits),
                                   **KV8_TOL)
        assert j.output == t.output, (j.rid, j.output, t.output)


def test_packed_weights_tokens_match_jax(model):
    (_, jreq), (eng, treq) = _serve_both(model, weight_bits=4, page_size=4,
                                         prefill_chunk=3)
    assert eng.plan.backend == "reference" and eng.plan.bits == 4
    for j, t in zip(jreq, treq):
        assert j.output == t.output, (j.rid, j.output, t.output)


def test_submit_rejects_bad_prompts(model):
    _, _, tcfg, tparams = model
    eng = ServeEngine(tcfg, tparams, n_slots=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])
    with pytest.raises(ValueError, match="outside the model vocabulary"):
        eng.submit([1, tcfg.vocab_size])
    with pytest.raises(ValueError, match="outside the model vocabulary"):
        eng.submit([-1])
    with pytest.raises(ValueError, match="cannot fit max_len"):
        eng.submit([1] * 31)
    assert not eng.has_work()


def test_cancel_releases_pages(model):
    _, _, tcfg, tparams = model
    eng = ServeEngine(tcfg, tparams, tconfig.ServeConfig(max_new_tokens=4),
                      n_slots=2, max_len=32, page_size=4, device="cpu")
    a, b, c = (eng.submit(p) for p in PROMPTS[:3])
    eng.step()
    assert eng.cancel(a) and eng.cancel(c)
    assert not eng.cancel(a)
    eng.alloc.audit()
    done = eng.run()
    assert [r.rid for r in done] == [b.rid] and len(b.output) == 4
    assert a.finish_reason == c.finish_reason == "cancelled"
    assert eng.alloc.used_pages == 0
    eng.alloc.audit()


def test_unported_options_are_refused(model):
    """The prefix cache, the budget scheduler and audits are ported: each
    constructs and serves the same tokens as the plain FCFS engine.  So is
    the sharded engine: ``EngineConfig(sharded=True)`` resolves to the
    ``sharded`` backend around the configured one, which without a mesh
    serves the wrapped backend's tokens (its mesh tests are in
    ``test_torch_shard_engine.py``)."""
    _, _, tcfg, tparams = model
    outputs = []
    for kw in ({}, dict(prefix_cache=True), dict(sched="budget"),
               dict(audit=1)):
        eng = ServeEngine(tcfg, tparams,
                          tconfig.ServeConfig(max_new_tokens=4, **kw),
                          n_slots=2, max_len=32, page_size=4,
                          prefill_chunk=3, device="cpu")
        reqs = [eng.submit(p) for p in PROMPTS]
        eng.run()
        assert all(r.done and len(r.output) == 4 for r in reqs)
        outputs.append([r.output for r in reqs])
    assert eng.scfg.audit == 1
    assert all(o == outputs[0] for o in outputs[1:])
    eng = ServeEngine(tcfg, tparams, tconfig.ServeConfig(
        max_new_tokens=4, engine=tconfig.EngineConfig(
            weight_bits=8, backend="reference", sharded=True)),
        n_slots=2, max_len=32, page_size=4, prefill_chunk=3, device="cpu")
    assert (eng.plan.backend, eng.plan.inner_backend) == ("sharded",
                                                          "reference")
    plain = ServeEngine(tcfg, tparams, tconfig.ServeConfig(
        max_new_tokens=4, engine=tconfig.EngineConfig(
            weight_bits=8, backend="reference")),
        n_slots=2, max_len=32, page_size=4, prefill_chunk=3, device="cpu")
    for e in (eng, plain):
        for p in PROMPTS:
            e.submit(p)
    assert ([r.output for r in sorted(eng.run(), key=lambda r: r.rid)]
            == [r.output for r in sorted(plain.run(), key=lambda r: r.rid)])


# ----------------------------------------------- the dense configs
DENSE_ARCHS = ["starcoder2-15b", "gemma3-27b", "mistral-large-123b"]
# int8 pages at 4-bit weights: the pools hold the same codes and scales
# in both packages, but the 4-bit GEMVs' last-bit differences reach the
# scores, and a bf16 rounding of ``p * s_v`` that falls the other way moves
# an attention output by a bf16 ulp (2^-8 relative); reduced
# mistral-large-123b's logits (|x| < 3.5) then differ by up to 2.6e-3
# (1.7e-6 at float32 weights, 3.9e-6 with full-precision pages)
DENSE_KV8_TOL = dict(rtol=1e-3, atol=5e-3)
# gemma3's reduced window is 8 keys: prompts of 9-21 tokens pass it
DENSE_PROMPTS = [list(range(1, 22)), [4, 5, 6, 7, 8, 9, 10, 11, 12],
                 [9] * 14, [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]]


@pytest.fixture(scope="module")
def dense_models():
    out = {}
    for arch in DENSE_ARCHS:
        cfg = reduced_f32(arch)
        params = init_params(cfg, jax.random.PRNGKey(0))
        tcfg = torch_cfg(cfg)
        out[arch] = (cfg, params, tcfg, params_from_numpy(
            jax_params_to_numpy(params), tcfg, device="cpu"))
    return out


@pytest.mark.parametrize("attn_backend", ["gather", "cuda"])
@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_configs_tokens_match_jax(dense_models, arch, kv_bits,
                                        attn_backend):
    """Reduced starcoder2-15b (GELU MLP), gemma3-27b (window 8 on two of
    every three layers, prompts past it) and mistral-large-123b, served
    paged at 4-bit weights: the port's greedy tokens equal JAX's
    ``gather`` serve path, and with int8 pages the final logits agree
    within DENSE_KV8_TOL.  ``cuda`` on the CPU runs the paged kernels'
    plain versions behind their wrappers (windows included)."""
    (_, jreq), (teng, treq) = _serve_both(
        dense_models[arch], weight_bits=4, kv_bits=kv_bits, max_new=6,
        max_len=48, prompts=DENSE_PROMPTS, page_size=4, prefill_chunk=5,
        port_attn=attn_backend)
    assert teng.attn_backend == attn_backend
    for j, t in zip(jreq, treq):
        assert j.output == t.output, (arch, j.rid, j.output, t.output)
        if kv_bits:
            np.testing.assert_allclose(t.last_logits, j.last_logits,
                                       **DENSE_KV8_TOL)


# ------------------------------------------------------------ moe family
MOE_ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]
# int8 pages: both packages round q and ``p * s_v`` to bf16, so a last-bit
# difference upstream (float32 sums in another order, XLA's exp against
# PyTorch's) can move one rounding by a bf16 ulp; reduced llama4-scout's
# final logits then differ by up to 2.7e-3 even at float32 weights (2e-6
# for reduced qwen3-moe), the case DENSE_KV8_TOL states for
# mistral-large-123b
MOE_KV8_TOL = DENSE_KV8_TOL
MOE_PROMPTS = PROMPTS + [[11, 12, 13, 14, 15, 16, 17], [3, 3, 3]]


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_model(request):
    cfg = reduced_f32(request.param)
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    return cfg, params, tcfg, params_from_numpy(jax_params_to_numpy(params),
                                                tcfg, device="cpu")


@pytest.mark.parametrize("weight_bits,kv_bits,attn_backend",
                         [(0, 0, "gather"), (4, 0, "gather"),
                          (0, 8, "gather"), (4, 8, "gather"),
                          (4, 8, "cuda")])
def test_moe_tokens_and_logits_match_jax(moe_model, weight_bits, kv_bits,
                                         attn_backend):
    """Reduced qwen3-moe and llama4-scout served paged: JAX's greedy tokens
    (``gather`` serve path), final logits within rtol = atol = 1e-4 with
    full-precision pages and MOE_KV8_TOL with int8 ones.  ``cuda`` on the
    CPU runs the paged kernels' and the grouped GEMV's plain versions
    behind their wrappers."""
    (_, jreq), (eng, treq) = _serve_both(
        moe_model, weight_bits=weight_bits, kv_bits=kv_bits, max_new=6,
        prompts=MOE_PROMPTS, page_size=4, prefill_chunk=3,
        port_attn=attn_backend)
    tol = MOE_KV8_TOL if kv_bits else dict(rtol=1e-4, atol=1e-4)
    for j, t in zip(jreq, treq):
        assert j.output == t.output, (j.rid, j.output, t.output)
        np.testing.assert_allclose(t.last_logits, np.asarray(j.last_logits),
                                   **tol)
    assert eng.expert_counts["decode"].shape == (eng.cfg.n_layers,
                                                 eng.cfg.n_experts)
    assert len(eng.experts_touched["decode"]) == len(eng.timings["decode"])


def test_moe_preemption_tokens_match_jax(moe_model):
    """A pool too small for every resident preempts and recomputes in both
    engines at the same steps.  A recomputed prompt is chunked anew and
    capacity is per row per chunk, so its tokens may differ from an
    uninterrupted run's, in JAX as in the port: here they equal JAX's."""
    (jeng, jreq), (teng, treq) = _serve_both(
        moe_model, n_slots=3, max_len=48, max_new=16, page_size=4,
        n_pages=14, prefill_chunk=4)
    assert teng.preemptions > 0
    assert teng.preemptions == jeng.sched.preemptions
    for j, t in zip(jreq, treq):
        assert j.output == t.output, (j.rid, j.output, t.output)
