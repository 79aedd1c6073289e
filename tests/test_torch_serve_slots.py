"""PyTorch port vs JAX: the fixed-slot ``ServeEngine`` (``mode="slots"``).

The port's engine on the CPU (plain GEMV, eager steps) against JAX
``ServeEngine(mode="slots")`` on reduced qwen2.5-3b (dense) and reduced
mamba2-130m (ssm) in float32, mirroring ``tests/test_serve_slots.py``:
more requests than slots, with engine-packed weights (``weight_bits=4``)
and without; the ``n_slots == n_layers`` merge case; slot reuse; a frozen
slot's cache while another slot prefills; ``max_new_tokens=0``; the
``mode="auto"`` fallback and its warning; and the slots-mode refusals,
with JAX's exception types.  Both engines get the same weights (JAX
``init_params`` through ``params_from_numpy``) and quantize them at
construction.

Greedy tokens must be equal, and each request's final logits within
rtol = atol = 1e-4, the tolerance of ``tests/test_torch_full_sequence.py``
for the same ``decode_step`` (float32 sums taken in another order).  A
frozen slot's cache is compared bit for bit.
"""

import functools
import logging

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
from test_torch_model import jax_params_to_numpy, torch_cfg

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen2.5-3b", "mamba2-130m"]
PROMPTS = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10]]
PORT_LOGGER = "repro_torch.serve.engine"


@functools.lru_cache(maxsize=None)
def _model(arch, seed=0):
    cfg = reduced_f32(arch)
    params = init_params(cfg, jax.random.PRNGKey(seed))
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    return cfg, params, tcfg, tparams


def _jax_engine(arch, *, seed=0, weight_bits=0, max_new=4, mode="slots",
                scfg=None, **kw):
    cfg, params, _, _ = _model(arch, seed)
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 32)
    scfg = scfg or JaxServeConfig(
        max_new_tokens=max_new,
        engine=JaxEngineConfig(weight_bits=weight_bits, backend="reference"))
    return JaxServeEngine(cfg, params, scfg, mode=mode, **kw)


def _port_engine(arch, *, seed=0, weight_bits=0, max_new=4, mode="slots",
                 scfg=None, **kw):
    _, _, tcfg, tparams = _model(arch, seed)
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 32)
    scfg = scfg or tconfig.ServeConfig(
        max_new_tokens=max_new,
        engine=tconfig.EngineConfig(weight_bits=weight_bits))
    return ServeEngine(tcfg, tparams, scfg, mode=mode, device="cpu", **kw)


def _serve(eng, prompts):
    reqs = [eng.submit(p) for p in prompts]
    done = eng.run()
    assert sorted(r.rid for r in done) == [r.rid for r in reqs]
    return reqs


def _assert_same(jreqs, treqs):
    for j, t in zip(jreqs, treqs):
        assert j.output == t.output, (j.rid, j.output, t.output)
        np.testing.assert_allclose(t.last_logits, np.asarray(j.last_logits),
                                   **TOL)


# ------------------------------------------------------------ tokens
@pytest.mark.parametrize("weight_bits", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_match_jax_more_requests_than_slots(arch, weight_bits):
    jreqs = _serve(_jax_engine(arch, weight_bits=weight_bits, max_new=5),
                   PROMPTS)
    eng = _port_engine(arch, weight_bits=weight_bits, max_new=5)
    assert eng.mode == "slots" and not eng.cuda_graphs
    if weight_bits:
        assert eng.plan.bits == 4 and eng.plan.backend == "reference"
    treqs = _serve(eng, PROMPTS)
    assert all(r.done and len(r.output) == 5 for r in treqs)
    _assert_same(jreqs, treqs)
    # one entry per prompt's sequential prefill, one per decode step, and
    # no capture: the CPU runs every step eagerly
    assert len(eng.timings["prefill"]) == len(PROMPTS)
    assert len(eng.timings["decode"]) >= 5
    assert eng.timings["capture"] == [] and eng.capture_seconds == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_merge_cache_when_n_slots_equals_n_layers(arch):
    """With n_slots == n_layers the JAX package's old axis guess merged
    along the layer axis; here every slot must serve as it does alone,
    and as JAX's engine serves it."""
    cfg = _model(arch, 2)[2]
    assert cfg.n_layers == 3  # the collision this test exists for
    prompts = [[1, 2, 3], [4], [5, 6], [7, 8, 9]]
    alone = []
    for p in prompts:
        alone.append(_serve(_port_engine(arch, seed=2, max_new=6,
                                         n_slots=1), [p])[0].output)
    treqs = _serve(_port_engine(arch, seed=2, max_new=6, n_slots=3), prompts)
    assert [r.output for r in treqs] == alone
    jreqs = _serve(_jax_engine(arch, seed=2, max_new=6, n_slots=3), prompts)
    _assert_same(jreqs, treqs)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_reuse_resets_state(arch):
    """A request admitted into a retired request's slot starts from an
    empty position and, for the ssm family, zero conv/h states."""
    solo = _serve(_port_engine(arch, seed=3, max_new=5, n_slots=1),
                  [[9, 8, 7]])[0]
    eng = _port_engine(arch, seed=3, max_new=5, n_slots=1)
    first, second = _serve(eng, [[1, 2, 3, 4], [9, 8, 7]])
    assert first.done and second.done
    assert second.output == solo.output
    jreqs = _serve(_jax_engine(arch, seed=3, max_new=5, n_slots=1),
                   [[1, 2, 3, 4], [9, 8, 7]])
    _assert_same(jreqs, [first, second])


def _slot_view(cache, slot):
    """Copies of every cache leaf of one slot (``pos`` is ``(B,)``, the
    others ``(L, B, ...)``)."""
    return {name: (t[slot] if name == "pos" else t[:, slot]).clone()
            for name, t in cache.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_frozen_slot_cache_bit_identical(arch):
    """While one slot prefills, every other slot's cache (K/V or conv/h,
    and pos) stays bit-identical, as JAX's ``_merge_cache`` keeps it."""
    eng = _port_engine(arch, n_slots=2)
    eng.submit([1, 2, 3])
    eng._admit()                      # request 0 prefilled into slot 0
    before = _slot_view(eng.cache, 0)
    assert int(before["pos"]) == 3
    eng.submit([7, 8, 9, 10, 11])
    eng._admit()                      # request 1 prefills into slot 1
    after = _slot_view(eng.cache, 0)
    assert set(before) == set(after) == set(eng.cache)
    for name in before:
        assert torch.equal(before[name], after[name]), name
    assert int(eng.cache["pos"][1]) == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_max_new_tokens_zero(arch):
    """max_new_tokens=0 retires with an empty output."""
    eng = _port_engine(arch)
    r0 = eng.submit([1, 2, 3], max_new_tokens=0)
    r1 = eng.submit([4, 5], max_new_tokens=3)
    done = eng.run()
    assert len(done) == 2
    assert r0.done and r0.output == []
    assert r1.done and len(r1.output) == 3
    jeng = _jax_engine(arch)
    j0 = jeng.submit([1, 2, 3], max_new_tokens=0)
    j1 = jeng.submit([4, 5], max_new_tokens=3)
    jeng.run()
    assert (j0.output, j1.output) == (r0.output, r1.output)


def test_slots_submit_rejects_bad_prompts():
    eng = _port_engine("mamba2-130m", max_len=16)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])
    with pytest.raises(ValueError, match="vocabulary"):
        eng.submit([1, eng.cfg.vocab_size])
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(list(range(1, 16)))
    req = eng.submit(list(range(1, 15)), max_new_tokens=100)
    assert eng.run() == [req] and len(req.output) == 1


def test_slots_cancel():
    eng = _port_engine("qwen2.5-3b", n_slots=1)
    a, b, c = (eng.submit(p) for p in PROMPTS[:3])
    eng.step()                        # a resident, b and c queued
    assert eng.cancel(a) and eng.cancel(c) and not eng.cancel(a)
    assert eng.run() == [b] and len(b.output) == 4
    assert a.finish_reason == c.finish_reason == "cancelled"


# --------------------------------------------------- mode="auto"
def test_auto_falls_back_to_slots_with_warning(caplog):
    """The ssm family falls back from mode="auto" to slots, with a warning
    that names the family, in both packages."""
    with caplog.at_level(logging.WARNING, logger=PORT_LOGGER):
        eng = _port_engine("mamba2-130m", mode=None)
    assert eng.mode == "slots"
    msgs = [r.message for r in caplog.records if r.name == PORT_LOGGER
            and "falling back to mode='slots'" in r.message]
    assert msgs and repr("ssm") in msgs[0], caplog.records
    assert _jax_engine("mamba2-130m", mode=None).mode == "slots"


def test_auto_paged_family_does_not_warn(caplog):
    with caplog.at_level(logging.WARNING, logger=PORT_LOGGER):
        eng = _port_engine("qwen2.5-3b", mode=None)
    assert eng.mode == "paged"
    assert not [r for r in caplog.records if "falling back" in r.message]


# ----------------------------------------------------------- refusals
REFUSED = {
    "kv_bits": dict(mode="slots", kv_bits=8),
    "prefix_cache": dict(mode="slots", prefix_cache=True),
    "budget": dict(mode="slots", sched="budget"),
    "audit": dict(mode="slots", audit=1),
    "paged_ssm": dict(mode="paged", arch="mamba2-130m"),
    "unknown_mode": dict(mode="ring"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_slots_refusals_match_jax(case):
    kw = dict(REFUSED[case])
    mode, arch = kw.pop("mode"), kw.pop("arch", "qwen2.5-3b")
    kv_bits = kw.pop("kv_bits", 0)
    jscfg = JaxServeConfig(engine=JaxEngineConfig(kv_bits=kv_bits), **kw)
    tscfg = tconfig.ServeConfig(engine=tconfig.EngineConfig(kv_bits=kv_bits),
                                **kw)
    with pytest.raises(ValueError) as jerr:
        _jax_engine(arch, mode=mode, scfg=jscfg)
    with pytest.raises(ValueError) as terr:
        _port_engine(arch, mode=mode, scfg=tscfg)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("option", ["prefix_cache", "budget", "audit"])
def test_auto_fallback_ignores_paged_options(option, caplog):
    """After auto's fallback the prefix cache is dropped silently and the
    budget scheduler and audits are ignored with a warning, as JAX does."""
    kw = {"prefix_cache": dict(prefix_cache=True),
          "budget": dict(sched="budget"), "audit": dict(audit=1)}[option]
    with caplog.at_level(logging.WARNING):
        _jax_engine("mamba2-130m", mode=None, scfg=JaxServeConfig(**kw))
        eng = _port_engine("mamba2-130m", mode=None,
                           scfg=tconfig.ServeConfig(max_new_tokens=2, **kw))
    assert eng.mode == "slots"
    said = {name: [r.message for r in caplog.records if r.name == name]
            for name in ("repro.serve.engine", PORT_LOGGER)}
    assert said[PORT_LOGGER] == said["repro.serve.engine"]
    assert len(said[PORT_LOGGER]) == 1 + (option != "prefix_cache")
    assert len(_serve(eng, [[1, 2]])[0].output) == 2


def test_unported_families_are_refused():
    """Every family serves now: the audio family (musicgen) in slots mode
    and paged (``auto``), with JAX's tokens in slots mode; only paged
    serving of the hybrid family is refused, with JAX's ``ValueError``."""
    for mode in ("slots", "auto"):
        eng = _port_engine("musicgen-medium", mode=mode)
        assert eng.mode == ("paged" if mode == "auto" else "slots")
        treqs = _serve(eng, [[1, 2, 3], [4]])
    jreqs = _serve(_jax_engine("musicgen-medium", mode="slots"),
                   [[1, 2, 3], [4]])
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    with pytest.raises(ValueError) as jerr:
        _jax_engine("zamba2-7b", mode="paged")
    with pytest.raises(ValueError, match="'hybrid'") as terr:
        _port_engine("zamba2-7b", mode="paged")
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------ moe family
MOE_ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]


@pytest.mark.parametrize("weight_bits", [0, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_tokens_match_jax_in_slots_mode(arch, weight_bits):
    """Reduced qwen3-moe and llama4-scout in slots mode, more requests
    than slots: JAX's greedy tokens and final logits (each lane routes its
    own token, so a frozen slot's garbage token changes no other lane)."""
    prompts = PROMPTS + [[11, 12, 13, 14, 15]]
    jreqs = _serve(_jax_engine(arch, weight_bits=weight_bits, max_new=5),
                   prompts)
    eng = _port_engine(arch, weight_bits=weight_bits, max_new=5)
    assert eng.mode == "slots"
    treqs = _serve(eng, prompts)
    assert all(r.done and len(r.output) == 5 for r in treqs)
    _assert_same(jreqs, treqs)
