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
                max_len=32, prompts=PROMPTS, **kw):
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
                n_slots=n_slots, max_len=max_len, attn_backend="gather",
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
    _, _, tcfg, tparams = model
    for scfg in (tconfig.ServeConfig(prefix_cache=True),
                 tconfig.ServeConfig(sched="budget"),
                 tconfig.ServeConfig(audit=1)):
        with pytest.raises(NotImplementedError, match="not ported"):
            ServeEngine(tcfg, tparams, scfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        tconfig.EngineConfig(sharded=True)
