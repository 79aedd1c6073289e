"""PyTorch port vs JAX: deterministic chaos injection and per-request
fault isolation (``repro_torch.ft``), mirroring ``tests/test_chaos.py``
and the chaos cases of ``tests/test_trace_chaos.py``.

* ``ChaosInjector``: for each seed and site, the port fires at the same
  checks and picks the same victims as the JAX package (the string seed
  ``f"{seed}/{site}/{idx}/{salt}"``), and the injector's own contract
  (replay, independent sites, schedules, refusals, summary) holds.
* Isolation: the same traffic (``make_engine`` of
  ``tests/test_torch_prefix_cache.py``: reduced qwen2.5-3b in float32,
  page 4, chunk 3, 2 lanes, max_len 32, 5 new tokens, the same weights)
  through both packages' engines under the same injector arguments gives
  the same tokens, ``finish_reason`` s, ``retries``, ``retried``,
  ``quarantined`` and fired faults; retried requests keep the fault-free
  run's tokens; a quarantine scrubs the lane's private pages (kv_bits 0
  and 8: NaN planted in the values or in the scales) and the pool serves
  the next request as a clean engine does; the front end ends a
  quarantined stream in ``error`` and fires its own sites as JAX does.
* Traces stay valid and every timeline terminal under retries and
  quarantines.
* A seeded random-operation storm with every site active runs on both
  packages with the auditor after every operation: the same outputs and
  counters.
* ``RestartPolicy`` (each request's retry budget) and
  ``run_with_restarts`` behave as the JAX package's.
"""

import random

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.ft import ChaosInjector as JaxChaosInjector
from repro.ft.chaos import SITES as JAX_SITES
from repro.models import init_params
from repro.serve import ServeFrontend as JaxServeFrontend

from repro_torch.ft import SITES, ChaosInjector
from repro_torch.obs import Telemetry, spans, validate_trace
from repro_torch.serve import ServeFrontend
from repro_torch.weights import params_from_numpy

from conftest import reduced_f32
from test_torch_model import jax_params_to_numpy, torch_cfg
from test_torch_prefix_cache import make_engine

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10]]
INJECTOR = {"jax": JaxChaosInjector, "torch": ChaosInjector}


@pytest.fixture(scope="module")
def model():
    cfg = reduced_f32("qwen2.5-3b")
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    return cfg, params, tcfg, tparams


def _engine(model, pkg, *, chaos=None, max_new=5, n_slots=2, max_len=32,
            audit=0, **kw):
    return make_engine(model, pkg, max_new=max_new, n_slots=n_slots,
                       max_len=max_len, page_size=4, prefill_chunk=3,
                       audit=audit, chaos=chaos, **kw)


def _run(model, pkg, chaos_kw=None, **kw):
    chaos = INJECTOR[pkg](**chaos_kw) if chaos_kw is not None else None
    eng = _engine(model, pkg, chaos=chaos, **kw)
    for p in PROMPTS:
        eng.submit(p)
    done = eng.run()
    return eng, {r.rid: r for r in done}, chaos


def _facts(eng, done, chaos):
    return dict(
        tokens={rid: list(r.output) for rid, r in done.items()},
        reasons={rid: r.finish_reason for rid, r in done.items()},
        retries={rid: r.retries for rid, r in done.items()},
        retried=eng.retried, quarantined=eng.quarantined,
        preemptions=eng.preemptions, log=list(chaos.log),
        ft=eng.metrics()["ft"])


def _both(model, chaos_kw, **kw):
    """Run the same traffic and injector through JAX and the port; their
    facts must be equal.  Returns the port's engine, requests, injector."""
    facts = {}
    for pkg in ("jax", "torch"):
        eng, done, chaos = _run(model, pkg, chaos_kw, **kw)
        facts[pkg] = _facts(eng, done, chaos)
    assert facts["torch"] == facts["jax"]
    return eng, done, chaos


@pytest.fixture(scope="module")
def baseline(model):
    _, done, _ = _run(model, "torch", audit=1)
    return {rid: list(r.output) for rid, r in done.items()}


# ------------------------------------------------------------- injector
@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_fire_and_pick_equal_jax(seed, site):
    kw = dict(seed=seed, rates={site: 0.3}, schedule={site: {2, 5}},
              skew_s=1.5)
    port, ref = ChaosInjector(**kw), JaxChaosInjector(**kw)
    seq = []
    for _ in range(200):
        fired = port.fire(site)
        assert fired == ref.fire(site)
        if fired:
            for n in (1, 2, 7):
                seq.append(port.pick(site, n))
                assert seq[-1] == ref.pick(site, n)
    assert port.log == ref.log and port.summary() == ref.summary()
    assert port.count(site) == ref.count(site) == 200
    assert port.fired(site) > 2 and len(seq) == 3 * port.fired(site)
    assert SITES == JAX_SITES


class TestInjector:
    def test_same_seed_replays_exactly(self):
        a = ChaosInjector(seed=9, rates={"step_fault": 0.3,
                                         "nan_logits": 0.2})
        b = ChaosInjector(seed=9, rates={"step_fault": 0.3,
                                         "nan_logits": 0.2})
        for _ in range(200):
            assert a.fire("step_fault") == b.fire("step_fault")
            assert a.fire("nan_logits") == b.fire("nan_logits")
        assert a.log == b.log
        assert a.pick("step_fault", 7) == b.pick("step_fault", 7)

    def test_sites_are_independent_streams(self):
        a = ChaosInjector(seed=9, rates={"step_fault": 0.3})
        b = ChaosInjector(seed=9, rates={"step_fault": 0.3,
                                         "page_grant": 0.5})
        seq_a, seq_b = [], []
        for i in range(100):
            if i % 3 == 0:
                b.fire("page_grant")
            seq_a.append(a.fire("step_fault"))
            seq_b.append(b.fire("step_fault"))
        assert seq_a == seq_b

    def test_schedule_fires_exact_occurrences(self):
        ch = ChaosInjector(seed=0, schedule={"cancel": {0, 3}})
        fired = [ch.fire("cancel") for _ in range(6)]
        assert fired == [True, False, False, True, False, False]
        assert ch.log == [("cancel", 0), ("cancel", 3)]
        assert ch.fired("cancel") == 2 and ch.fired() == 2

    def test_unknown_site_rejected(self):
        with pytest.raises(ValueError):
            ChaosInjector(rates={"not_a_site": 0.5})
        with pytest.raises(ValueError):
            ChaosInjector(schedule={"bogus": {1}})
        with pytest.raises(ValueError):
            ChaosInjector().fire("bogus")
        with pytest.raises(ValueError):
            ChaosInjector().pick("step_fault", 0)

    def test_summary_counts_by_site(self):
        ch = ChaosInjector(seed=1, schedule={"step_fault": {0, 1},
                                             "cancel": {0}})
        for _ in range(3):
            ch.fire("step_fault")
            ch.fire("cancel")
        assert ch.summary() == {"step_fault": 2, "cancel": 1}


# ------------------------------------------------- per-request isolation
class TestIsolation:
    def test_page_grant_faults_token_identity(self, model, baseline):
        eng, done, ch = _both(model, dict(seed=3, rates={"page_grant": 0.3}),
                              audit=2, max_request_retries=3)
        assert ch.fired("page_grant") > 0
        for rid, r in done.items():
            if r.finish_reason != "error":
                assert list(r.output) == baseline[rid], rid
        eng.audit()

    def test_nan_retry_preserves_tokens(self, model, baseline):
        eng, done, ch = _both(model, dict(seed=5, schedule={"nan_logits":
                                                            {2}}),
                              audit=1, max_request_retries=2)
        assert ch.fired("nan_logits") == 1
        assert eng.quarantined == 0
        assert {rid: list(r.output) for rid, r in done.items()} == baseline
        assert any(r.retries == 1 for r in done.values())

    def test_nan_quarantine_isolates_one_request(self, model, baseline):
        eng, done, _ = _both(model, dict(seed=5, schedule={"nan_logits":
                                                           {2}}),
                             audit=1, max_request_retries=0)
        errs = [r for r in done.values() if r.finish_reason == "error"]
        assert len(errs) == 1 and eng.quarantined == 1
        assert errs[0].cancelled and not errs[0].done
        assert len(done) == len(PROMPTS)
        for rid, r in done.items():
            if r.finish_reason != "error":
                assert list(r.output) == baseline[rid], rid
        assert eng.metrics()["quarantined"] == 1
        assert eng.alloc.refcount.sum() == 0
        eng.audit()

    def test_step_faults_and_preempt_storms(self, model, baseline):
        eng, done, ch = _both(model, dict(seed=7, rates={
            "step_fault": 0.15, "preempt_storm": 0.1}),
            audit=2, max_request_retries=5)
        assert ch.fired("step_fault") > 0 and ch.fired("preempt_storm") > 0
        assert eng.retried > 0 and eng.preemptions > 0
        for rid, r in done.items():
            if r.finish_reason != "error":
                assert list(r.output) == baseline[rid], rid

    @pytest.mark.parametrize("kv_bits", [0, 8])
    def test_quarantine_scrubs_poisoned_pages(self, model, kv_bits):
        """NaN planted in a faulted lane's pages (the values of a float
        pool, the scales of an int8 one) is zeroed in place before the
        pages return to the free list; the pool keeps its storage and
        serves the next request as a clean engine does."""
        clean = _engine(model, "torch", n_slots=1, kv_bits=kv_bits)
        clean.submit([5, 6, 7])
        want = list(clean.run()[0].output)
        ref = _engine(model, "jax", n_slots=1, kv_bits=kv_bits)
        ref.submit([5, 6, 7])
        assert list(ref.run()[0].output) == want

        eng = _engine(model, "torch", n_slots=1, max_request_retries=0,
                      kv_bits=kv_bits)
        victim = eng.submit([1, 2, 3, 4, 5])
        eng.step()
        private = list(eng.alloc._mapped[0])
        assert private
        names = ["k_scale", "v_scale"] if kv_bits else ["k", "v"]
        tensors = [getattr(eng.pages, n) for n in ("k", "v", "k_scale",
                                                   "v_scale")
                   if getattr(eng.pages, n) is not None]
        ptrs = [t.data_ptr() for t in tensors]
        for n in names:
            getattr(eng.pages, n)[:, private] = float("nan")
        eng._fault(0, victim, "nan_logits")
        assert victim.finish_reason == "error"
        for t in tensors:
            assert torch.isfinite(t.float()).all()
            assert not t[:, private].any()
        assert [t.data_ptr() for t in tensors] == ptrs
        eng.audit()
        after = eng.submit([5, 6, 7])
        eng.step()
        assert set(eng.alloc._mapped[0]) & set(private)
        eng.run()
        assert list(after.output) == want

    def test_frontend_surfaces_error_state(self, model):
        states = {}
        for pkg in ("jax", "torch"):
            ch = INJECTOR[pkg](seed=5, schedule={"nan_logits": {2}})
            eng = _engine(model, pkg, chaos=ch, max_request_retries=0)
            fe = (JaxServeFrontend if pkg == "jax" else ServeFrontend)(eng)
            streams = [fe.submit(p) for p in PROMPTS]
            fe.drain()
            states[pkg] = [(s.state, s.tokens) for s in streams]
        assert states["torch"] == states["jax"]
        got = [s for s, _ in states["torch"]]
        assert got.count("error") == 1, got
        assert all(s in ("done", "error") for s in got)

    def test_frontend_chaos_sites_equal_jax(self, model):
        """``cancel`` and ``deadline_skew`` fire in the front end's step,
        at the same checks and victims as in JAX."""
        out = {}
        for pkg in ("jax", "torch"):
            ch = INJECTOR[pkg](seed=2, schedule={"cancel": {1},
                                                 "deadline_skew": {3}},
                               skew_s=100.0)
            eng = _engine(model, pkg, chaos=ch, n_slots=2)
            fe = (JaxServeFrontend if pkg == "jax" else ServeFrontend)(
                eng, clock=lambda: 0.0)
            streams = [fe.submit(p, deadline_s=50.0 if i == 3 else None)
                       for i, p in enumerate(PROMPTS)]
            fe.drain()
            out[pkg] = ([(s.state, s.tokens) for s in streams], ch.log,
                        fe.timeout_count)
        assert out["torch"] == out["jax"]
        got = [s for s, _ in out["torch"][0]]
        assert "cancelled" in got and "timed_out" in got


# ----------------------------------------------------------- traces
def _assert_all_terminal(tel):
    states = {rid: tl.state for rid, tl in tel.timelines.items()}
    bad = {rid: s for rid, s in states.items() if s not in spans.TERMINAL}
    assert not bad, f"non-terminal timelines after run: {bad}"
    return states


def _traced(model, pkg, chaos_kw, retries):
    tel = (jobs.Telemetry if pkg == "jax" else Telemetry)(trace=True)
    eng = _engine(model, pkg, chaos=INJECTOR[pkg](**chaos_kw),
                  max_request_retries=retries, telemetry=tel)
    for p in PROMPTS:
        eng.submit(list(p))
    return eng, eng.run(), tel


def test_trace_valid_under_chaos_retries(model):
    kw = dict(seed=3, schedule={"step_fault": {1}})
    eng, done, tel = _traced(model, "torch", kw, 1)
    assert all(r.done for r in done)
    assert eng.retried >= 1
    counts = validate_trace(tel.tracer.export())
    assert sum(counts.values()) > 0
    states = _assert_all_terminal(tel)
    assert set(states.values()) == {spans.RETIRED}
    names = {(e["tid"], e["name"]) for e in tel.tracer.events}
    assert (1000, "fault") in names and (1000, "retry") in names
    _, _, jtel = _traced(model, "jax", kw, 1)
    assert tel.registry.to_dict()["counters"] == (
        jtel.registry.to_dict()["counters"])


def test_trace_valid_with_quarantine(model):
    kw = dict(seed=5, schedule={"nan_logits": {2}})
    eng, done, tel = _traced(model, "torch", kw, 0)
    errs = [r for r in done if r.finish_reason == "error"]
    assert len(errs) == 1 and eng.quarantined == 1
    validate_trace(tel.tracer.export())
    states = _assert_all_terminal(tel)
    assert states[errs[0].rid] == spans.ERRORED
    assert sorted(states.values()).count(spans.RETIRED) == len(PROMPTS) - 1
    _, _, jtel = _traced(model, "jax", kw, 0)
    assert {rid: tl.state for rid, tl in jtel.timelines.items()} == states
    assert tel.registry.to_dict()["counters"] == (
        jtel.registry.to_dict()["counters"])


# ------------------------------------------------------------------ soak
@pytest.mark.parametrize("seed", [0, 11, 4242])
def test_random_ops_equal_jax_and_hold_invariants(model, seed):
    """A seeded storm of submits, cancels and steps with every engine
    site firing, audited after every operation in both packages."""
    vocab = model[0].vocab_size
    out = {}
    for pkg in ("jax", "torch"):
        rng = random.Random(seed)
        ch = INJECTOR[pkg](seed=seed, rates={
            "page_grant": 0.05, "step_fault": 0.05, "nan_logits": 0.05,
            "preempt_storm": 0.02})
        eng = _engine(model, pkg, chaos=ch, prefix_cache=True, max_new=4,
                      max_request_retries=1)
        live, reqs = [], []
        for _ in range(30):
            op = rng.random()
            if op < 0.4:
                n = rng.randint(1, 6)
                req = eng.submit([rng.randint(1, vocab - 1)
                                  for _ in range(n)])
                live.append(req)
                reqs.append(req)
            elif op < 0.5 and live:
                eng.cancel(live.pop(rng.randrange(len(live))))
            elif eng.has_work():
                eng.step()
            eng.audit()
        while eng.has_work():
            eng.step()
            eng.audit()
        out[pkg] = ([(r.output, r.finish_reason, r.retries) for r in reqs],
                    ch.log, eng.retried, eng.quarantined, eng.preemptions,
                    eng.prefix_stats())
    assert out["torch"] == out["jax"]
    assert out["torch"][1], "no fault fired"


# ------------------------------------------------- the restart policy
@pytest.mark.parametrize("max_restarts,reset,steps", [
    (2, 0, [1, 2, 3]),
    (2, 10, [1, 5, 20, 21, 22]),
    (2, 10, [1, 9, 15]),
    (2, 0, [0, 10_000, 1_000_000]),
    (0, 0, [4]),
    (5, 3, [1, 2, 6, 7, 8, 9, 13, 14]),
])
def test_restart_policy_equals_jax(max_restarts, reset, steps):
    """The per-request retry budget: the same restarts, backoffs and
    exhaustion point as the JAX package's ``RestartPolicy``."""
    from repro.ft import RestartPolicy as JaxRestartPolicy

    from repro_torch.ft import RestartPolicy

    out = {}
    for cls in (RestartPolicy, JaxRestartPolicy):
        pol = cls(max_restarts=max_restarts, backoff_s=0.01,
                  backoff_cap_s=0.05, reset_after_steps=reset)
        seq = []
        for s in steps:
            try:
                seq.append((pol.on_failure(RuntimeError("x"), s),
                            pol.restarts))
            except RuntimeError:
                seq.append(("exhausted", pol.restarts))
                break
        out[cls] = seq
    assert out[RestartPolicy] == out[JaxRestartPolicy]


def test_run_with_restarts_equals_jax(monkeypatch):
    from repro.ft import FailureInjector as JaxFailureInjector
    from repro.ft import RestartPolicy as JaxRestartPolicy
    from repro.ft.failures import run_with_restarts as jax_run

    from repro_torch.ft import (
        FailureInjector,
        RestartPolicy,
        SimulatedNodeFailure,
        run_with_restarts,
    )

    runs = []
    for run, inj_cls, pol_cls in (
            (run_with_restarts, FailureInjector, RestartPolicy),
            (jax_run, JaxFailureInjector, JaxRestartPolicy)):
        executed, ckpt = [], {"step": 0}

        def step_fn(s):
            executed.append(s)
            if (s + 1) % 4 == 0:
                ckpt["step"] = s + 1

        restarts = run(step_fn, start_step=0, total_steps=12,
                       restore_fn=lambda: ckpt["step"],
                       policy=pol_cls(backoff_s=0.0),
                       injector=inj_cls(schedule={6: 1, 9: 2}))
        runs.append((restarts, executed))
    assert runs[0] == runs[1]
    assert runs[0][0] == 2 and set(range(12)) <= set(runs[0][1])
    inj = FailureInjector(schedule={3: 7})
    with pytest.raises(SimulatedNodeFailure) as err:
        inj.check(3)
    assert (err.value.node_id, err.value.step) == (7, 3)
    inj.check(3)  # consumed
