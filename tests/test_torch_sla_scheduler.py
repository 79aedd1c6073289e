"""PyTorch port vs JAX: the budget scheduler (``BudgetScheduler``),
mirroring ``tests/test_sla_scheduler.py``.

Engines of both packages (``tests/test_torch_prefix_cache.py``
``make_engine``: reduced qwen2.5-3b in float32, shared weights, the port
on the CPU) run the same traffic under ``ServeConfig(sched="budget")``:
greedy tokens must equal JAX's and the port's FCFS run; each engine
step's spend (prefill tokens plus decode tokens) must equal JAX's step
for step and never exceed ``step_tokens``; the weighted fair share must
take the same steps as JAX's under an interactive flood.  The fair-share
bookkeeping (virtual time, service order, admission around a blocked
request) runs on the same fake requests in both packages.
"""

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the container has no hypothesis
    from _hypothesis_shim import given, settings, strategies as st

import pytest
import torch

import repro_torch.config as tconfig
from repro.serve import BudgetScheduler as JaxBudgetScheduler
from repro.serve import PageAllocator as JaxPageAllocator
from repro_torch.serve import (
    PRIORITY_WEIGHTS,
    BudgetScheduler,
    PageAllocator,
    PagedScheduler,
)

from test_torch_prefix_cache import make_engine, model  # noqa: F401

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10]]
PRIOS = ["batch", "interactive", "default", "interactive"]


def _engine(model, pkg, *, sched="budget", step_tokens=0, n_slots=2,
            max_len=96, max_new=5, prefill_chunk=4, **kw):
    return make_engine(model, pkg, sched=sched, step_tokens=step_tokens,
                       n_slots=n_slots, max_len=max_len, max_new=max_new,
                       page_size=4, prefill_chunk=prefill_chunk, audit=1,
                       **kw)


def _spend_per_step(eng, reqs):
    """Run to the end; each step's (prefill tokens, decode tokens)."""
    spent, prev = [], (0, 0)
    while eng.has_work():
        eng.step()
        now = (eng.prefill_computed, sum(len(r.output) for r in reqs))
        spent.append((now[0] - prev[0], now[1] - prev[1]))
        prev = now
        assert len(spent) < 500, "scheduler stopped making progress"
    return spent


# -------------------------------------------------------------- identity
def test_budget_tokens_match_fcfs_and_jax(model):
    out = {}
    for pkg, sched in (("jax", "budget"), ("torch", "budget"),
                       ("torch", "fcfs")):
        eng = _engine(model, pkg, sched=sched, step_tokens=6, max_new=6)
        reqs = [eng.submit(list(p), priority=pr if sched == "budget"
                           else "default")
                for p, pr in zip(PROMPTS, PRIOS)]
        eng.run()
        out[pkg, sched] = (eng, [r.output for r in reqs])
        assert all(r.done and r.finish_reason == "length" for r in reqs)
    assert isinstance(out["torch", "budget"][0].sched, BudgetScheduler)
    assert type(out["torch", "fcfs"][0].sched) is PagedScheduler
    assert out["torch", "budget"][1] == out["jax", "budget"][1]
    assert out["torch", "budget"][1] == out["torch", "fcfs"][1]


# ---------------------------------------------------------------- budget
@pytest.mark.parametrize("step_tokens,chunk", [(7, 5), (2, 4), (0, 3)])
def test_per_step_spend_matches_jax_within_budget(model, step_tokens,
                                                  chunk):
    """Long and short prompts, admission waves and prefills completing
    mid-step (the completion reserve): the budget holds in every step,
    and each step spends what JAX's does.  ``step_tokens=0`` is the
    default budget, ``n_slots + chunk``."""
    lens = (29, 3, 17, 1, 40, 6)
    spends, outs = {}, {}
    for pkg in ("jax", "torch"):
        eng = _engine(model, pkg, step_tokens=step_tokens, n_slots=3,
                      max_new=4, prefill_chunk=chunk)
        reqs = [eng.submit(list(range(1, 1 + n)), max_new_tokens=4)
                for n in lens]
        spends[pkg] = _spend_per_step(eng, reqs)
        outs[pkg] = [r.output for r in reqs]
        assert all(r.done for r in reqs)
    budget = step_tokens or 3 + chunk
    assert eng.sched.step_tokens == budget
    assert spends["torch"] == spends["jax"]
    assert max(p + d for p, d in spends["torch"]) <= budget
    assert outs["torch"] == outs["jax"]


def test_step_tokens_validation():
    with pytest.raises(ValueError, match="step_tokens"):
        BudgetScheduler(PageAllocator(9, 4, 1, 16), chunk=4, step_tokens=1)
    with pytest.raises(ValueError, match="step_tokens"):
        tconfig.ServeConfig(step_tokens=-1)
    with pytest.raises(ValueError, match="sched"):
        tconfig.ServeConfig(sched="wfq")


def test_decode_advances_every_step_during_long_prefill(model):
    eng = _engine(model, "torch", step_tokens=6, max_new=12,
                  prefill_chunk=8)
    short = eng.submit([1, 2, 3], max_new_tokens=12)
    while short.last_logits is None:
        eng.step()
    long = eng.submit(list(range(100, 160)), max_new_tokens=2)
    overlap = 0
    while long.prefill_pos < len(long.prefill_tokens) and not short.done:
        before = len(short.output)
        eng.step()
        assert len(short.output) == before + 1, "decode lane stalled"
        overlap += 1
    assert overlap >= 8, overlap
    eng.run()
    assert short.done and long.done


# ----------------------------------------------------- fair share bound
def test_interactive_flood_matches_jax(model):
    """A batch-class request under a sustained interactive flood finishes
    within a bounded number of steps, after the same steps and the same
    completed flood as in JAX."""
    out = {}
    for pkg in ("jax", "torch"):
        eng = _engine(model, pkg, step_tokens=6, max_new=3)
        batch = eng.submit(list(range(1, 9)), max_new_tokens=3,
                           priority="batch", tenant="t-batch")
        flood, steps = [], 0
        while not batch.done:
            while len(eng.sched.queue) < 2:
                flood.append(eng.submit([100 + steps % 50, 101, 102],
                                        max_new_tokens=3,
                                        priority="interactive",
                                        tenant="t-inter"))
            eng.step()
            steps += 1
            assert steps < 400, "batch request starved"
        out[pkg] = (steps, [r.output for r in flood if r.done],
                    batch.output)
    assert out["torch"] == out["jax"]
    assert len(out["torch"][1]) >= 1 and len(out["torch"][2]) == 3


# ------------------------------------------------------- WFQ bookkeeping
class _FakeReq:
    def __init__(self, rid, priority="default", tenant="default"):
        self.rid = rid
        self.priority = priority
        self.tenant = tenant
        self.prefill_tokens = [1]
        self.prefill_pos = 0
        self.output = []
        self.max_new_tokens = 1
        self.last_logits = None


def _scheds(n_pages=33, n_slots=2, step_tokens=8):
    return [cls(alloc_cls(n_pages, 4, n_slots, 32), chunk=4,
                step_tokens=step_tokens)
            for cls, alloc_cls in ((JaxBudgetScheduler, JaxPageAllocator),
                                   (BudgetScheduler, PageAllocator))]


_CHARGES = st.lists(
    st.tuples(st.integers(0, 5),           # which fake request
              st.integers(1, 40),          # tokens served
              st.booleans()),              # is it queued (active) now
    min_size=1, max_size=30)


@settings(max_examples=40)
@given(charges=_CHARGES)
def test_wfq_vtime_and_order_match_jax(charges):
    """The same charges on the same fake requests (three priorities, two
    tenants): equal virtual times and service orders after each."""
    keys = [(p, t) for t in ("a", "b") for p in sorted(PRIORITY_WEIGHTS)]
    pair = []
    for sched in _scheds():
        reqs = [_FakeReq(i, p, t) for i, (p, t) in enumerate(keys)]
        pair.append((sched, reqs))
    for i, n, active in charges:
        orders = []
        for sched, reqs in pair:
            if active and reqs[i] not in sched.queue:
                sched.queue.append(reqs[i])
            elif not active and reqs[i] in sched.queue:
                sched.queue.remove(reqs[i])
            sched._charge(reqs[i], n)
            orders.append([r.rid for r in sched._service_order(reqs)])
        assert orders[0] == orders[1]
        assert pair[0][0]._vtime == pair[1][0]._vtime


def test_wfq_charge_and_order():
    _, s = _scheds()
    inter, batch = _FakeReq(0, "interactive"), _FakeReq(1, "batch")
    s._charge(inter, 8)
    s._charge(batch, 8)
    assert s._vtime[("default", "interactive")] == pytest.approx(1.0)
    assert s._vtime[("default", "batch")] == pytest.approx(8.0)
    assert [r.rid for r in s._service_order([batch, inter])] == [0, 1]
    order = s._service_order([_FakeReq(3, "batch", "t2"),
                              _FakeReq(2, "interactive", "t2")])
    assert [r.rid for r in order] == [2, 3]


def test_wfq_idle_key_gets_no_banked_credit():
    _, s = _scheds()
    a, b = _FakeReq(0, "default", "a"), _FakeReq(1, "default", "b")
    s._charge(a, 1)
    for _ in range(100):
        s._charge(b, 4)
    s.queue.append(b)
    s._charge(a, 4)
    assert s._vtime[("a", "default")] >= s._vtime[("b", "default")]


def test_budget_admission_skips_blocked_head_as_jax():
    """A request that cannot fit does not block a later one that does,
    in both packages, with the same lanes and pages."""
    states = []
    for sched in _scheds(n_pages=9):
        big, small, resident = _FakeReq(0), _FakeReq(1), _FakeReq(2)
        big.prefill_tokens = list(range(24))
        small.prefill_tokens = [1, 2, 3]
        resident.prefill_tokens = list(range(8))
        sched.queue.extend([big, small])
        assert sched._try_admit(0, resident)
        sched.admit()
        assert sched.slot_req[1] is small and big in sched.queue
        states.append((sched.alloc.block_tables.tolist(),
                       list(sched.alloc.free)))
    assert states[0] == states[1]
