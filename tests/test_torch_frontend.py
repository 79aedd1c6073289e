"""PyTorch port vs JAX: the streaming front end (``ServeFrontend`` /
``TokenStream``), mirroring ``tests/test_frontend.py``.

Front ends of both packages over engines of both (``make_engine`` of
``tests/test_torch_prefix_cache.py``: reduced qwen2.5-3b in float32,
shared weights, the port on the CPU, each engine auditing itself after
every phase) take the same traffic under the same manual clock: the
streamed tokens must equal JAX's and the port's own batch run, and every
stream's state and token count after every front-end step must equal
JAX's, through queueing, prefill, decode, cancellation mid-prefill,
deadlines and shedding.  Cancellation releases a request's pages and
prefix-cache pins at once (refcounts equal to JAX's).
"""

import numpy as np
import pytest
import torch

from repro.serve import ServeFrontend as JaxServeFrontend
from repro_torch.serve import AdmissionRejected, ServeFrontend
from repro_torch.serve.frontend import (
    CANCELLED,
    DECODING,
    DONE,
    QUEUED,
    SHED,
    TIMED_OUT,
)

from test_torch_prefix_cache import make_engine, model  # noqa: F401

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10]]
FRONTENDS = {"jax": JaxServeFrontend, "torch": ServeFrontend}


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _engine(model, pkg, *, n_slots=2, max_len=64, max_new=5, **kw):
    return make_engine(model, pkg, n_slots=n_slots, max_len=max_len,
                       max_new=max_new, page_size=4, prefill_chunk=3, **kw)


def _frontend(model, pkg, clock=None, **kw):
    eng = _engine(model, pkg, clock=clock, **kw)
    return eng, FRONTENDS[pkg](eng, clock=clock)


def _alloc_clean(eng):
    alloc = eng.alloc
    assert alloc.refcount.sum() == 0
    assert all(not m for m in alloc._mapped)
    cached = eng.prefix_cache.cached_pages if eng.prefix_cache else 0
    assert alloc.free_pages == alloc.n_pages - 1 - cached
    eng.audit()


def _view(streams):
    return [(s.state, list(s.tokens), s.shed_reason) for s in streams]


# -------------------------------------------------------------- identity
@pytest.mark.parametrize("sched", ["fcfs", "budget"])
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_streamed_tokens_match_batch_and_jax(model, sched, prefix_cache):
    """Streams consumed round-robin, one token at a time, yield the port's
    batch ``run()`` tokens and JAX's streamed tokens."""
    prompts = PROMPTS + [list(PROMPTS[0]), [2, 2, 2, 2, 2]]
    ref = _engine(model, "torch", prefix_cache=prefix_cache)
    refs = [ref.submit(list(p)) for p in prompts]
    ref.run()
    got = {}
    for pkg in ("jax", "torch"):
        eng, fe = _frontend(model, pkg, sched=sched,
                            prefix_cache=prefix_cache)
        streams = [fe.submit(list(p)) for p in prompts]
        iters = [iter(s) for s in streams]
        collected = [[] for _ in streams]
        pending = set(range(len(streams)))
        while pending:
            for i in sorted(pending):
                try:
                    collected[i].append(next(iters[i]))
                except StopIteration:
                    pending.discard(i)
        got[pkg] = collected
        assert all(s.state == DONE for s in streams)
        if pkg == "torch":
            _alloc_clean(eng)
            assert eng.prefix_stats() == ref.prefix_stats()
    assert got["torch"] == [r.output for r in refs]
    assert got["torch"] == got["jax"]


def _drive_script(model, pkg):
    """One lane too few, a warm prefix, a cancellation mid-prefill, a
    deadline, a shed stream, and time moving by hand: the streams' view
    after every front-end step."""
    clock = ManualClock()
    eng, fe = _frontend(model, pkg, clock=clock, prefix_cache=True,
                        max_new=6, max_queue=3)
    warm = list(range(1, 13))
    views = []
    first = fe.submit(warm)
    fe.step()
    streams = [first,
               fe.submit(warm[:10] + [30, 31], max_new_tokens=8),
               fe.submit(warm[:6] + [40], deadline_s=3.0),
               fe.submit([50, 51, 52], max_new_tokens=2)]
    streams.append(fe.submit([9, 9]))                  # the queue is full
    refs = []
    for step in range(40):
        if step == 2:
            streams[1].cancel()
        fe.step()
        clock.advance(1.0)
        views.append(_view(streams))
        refs.append(eng.alloc.refcount.tolist())
        if not fe.has_live():
            break
    return eng, fe, streams, views, refs


def test_stream_states_match_jax_under_manual_clock(model):
    out = {pkg: _drive_script(model, pkg) for pkg in ("jax", "torch")}
    eng, fe, streams, views, refs = out["torch"]
    assert views == out["jax"][3]
    assert refs == out["jax"][4]
    assert fe.timeout_count == out["jax"][1].timeout_count == 1
    assert fe.shed_count == out["jax"][1].shed_count == 1
    assert eng.prefix_stats() == out["jax"][0].prefix_stats()
    states = [s.state for s in streams]
    assert states == [DONE, CANCELLED, TIMED_OUT, DONE, SHED], states
    assert streams[4].shed_reason == "queue_full" and list(streams[4]) == []
    seen = {v[0][0] for v in views}
    assert {DECODING, DONE} <= seen
    assert streams[0].ttft() is not None and streams[0].ttft() >= 0
    _alloc_clean(eng)


def test_shed_when_queue_full(model):
    eng, fe = _frontend(model, "torch", n_slots=1, max_new=2, max_queue=2)
    streams = [fe.submit([10 + i], max_new_tokens=2) for i in range(6)]
    shed = [s for s in streams if s.state == SHED]
    live = [s for s in streams if s.state != SHED]
    assert len(shed) == 4 and fe.shed_count == 4 and eng.shed_count == 4
    assert all(s.shed_reason == "queue_full" for s in shed)
    assert all(list(s) == [] for s in shed)
    fe.drain()
    assert all(s.state == DONE and len(s.tokens) == 2 for s in live)
    _alloc_clean(eng)


def test_pool_too_small_is_shed_not_deadlock(model):
    # no audit: the pretended pool disagrees with the free list
    eng, fe = _frontend(model, "torch", max_len=96, max_new=2, audit=0)
    eng.alloc.n_pages = 9   # pretend only 8 usable pages exist
    s = fe.submit(list(range(60)))
    assert s.state == SHED and s.shed_reason == "pool_too_small"
    with pytest.raises(AdmissionRejected, match="pool_too_small"):
        eng.submit(list(range(60)))
    ok = fe.submit([1, 2, 3])
    fe.drain()
    assert ok.state == DONE


# ----------------------------------------------------------- cancellation
def test_cancel_mid_admission_releases_pins_as_jax(model):
    """Cancelled right after admission pinned shared pages, granted
    private ones and queued a fork: the fork is dropped, the pins and
    pages released (refcounts back to cache-only residency), and the
    refcounts equal JAX's at each point."""
    warm = list(range(1, 13))
    forker = warm[:10] + [99, 100]
    seen = {}
    for pkg in ("jax", "torch"):
        eng, fe = _frontend(model, pkg, prefix_cache=True)
        fe.submit(list(warm)).result()
        base = eng.alloc.refcount.copy()
        victim = fe.submit(list(forker), max_new_tokens=8)
        eng.sched.admit()
        assert any(f[1] != f[2] for f in eng.sched.pending_forks)
        pinned = eng.alloc.refcount.copy()
        assert pinned.sum() > base.sum()
        assert victim.cancel() and victim.state == CANCELLED
        assert eng.sched.pending_forks == []
        np.testing.assert_array_equal(eng.alloc.refcount, base)
        by = fe.submit([7, 8, 9])
        second = fe.submit(list(forker), max_new_tokens=8)
        fe.step()
        assert second.state in ("prefilling", "decoding")
        assert second.cancel()
        fe.drain()
        np.testing.assert_array_equal(eng.alloc.refcount, base)
        seen[pkg] = (pinned.tolist(), by.tokens)
        if pkg == "torch":
            _alloc_clean(eng)
    assert seen["torch"] == seen["jax"]


def test_cancel_queued_and_decoding(model):
    eng, fe = _frontend(model, "torch", n_slots=1, max_new=8)
    running = fe.submit([1, 2, 3], max_new_tokens=8)
    queued = fe.submit([4, 5], max_new_tokens=8)
    for _ in running:
        if len(running.tokens) >= 2:
            break
    assert running.state == DECODING and queued.state == QUEUED
    assert queued.cancel() and queued.state == CANCELLED
    got = len(running.tokens)
    assert running.cancel() and running.state == CANCELLED
    assert len(running.tokens) == got
    assert not fe.step()
    assert running.req.finish_reason == "cancelled"
    _alloc_clean(eng)
    assert not running.cancel()


def test_deadline_timeout_releases_and_reports(model):
    clock = ManualClock()
    eng, fe = _frontend(model, "torch", clock=clock, max_new=50)
    doomed = fe.submit([1, 2, 3], max_new_tokens=50, deadline_s=5.0)
    safe = fe.submit([4, 5, 6], max_new_tokens=3)
    for _ in range(4):
        fe.step()
        clock.advance(1.0)
    assert doomed.state in ("prefilling", "decoding")
    partial = len(doomed.tokens)
    clock.advance(10.0)
    fe.step()
    assert doomed.state == TIMED_OUT
    assert doomed.req.finish_reason == "timed_out"
    assert len(doomed.tokens) >= partial and fe.timeout_count == 1
    fe.drain()
    assert safe.state == DONE and len(safe.tokens) == 3
    _alloc_clean(eng)
    fe.submit([1] * 20, max_new_tokens=40)
    fe.submit([2] * 20, max_new_tokens=40)
    never = fe.submit([9, 9], deadline_s=0.5)
    clock.advance(1.0)
    fe.step()
    assert never.state == TIMED_OUT and never.tokens == []


def test_deadline_sweep_double_cancel_guard(model):
    clock = ManualClock()
    eng, fe = _frontend(model, "torch", clock=clock, max_new=50)
    s = fe.submit([1, 2, 3], deadline_s=1.0)
    fe.step()
    eng.cancel(s.req)
    clock.advance(5.0)
    fe.step()
    assert s.state == CANCELLED and s.req.finish_reason == "cancelled"
    assert fe.timeout_count == 0


def test_submit_validation_still_raises(model):
    _, fe = _frontend(model, "torch")
    with pytest.raises(ValueError, match="empty prompt"):
        fe.submit([])
    with pytest.raises(ValueError, match="priority"):
        fe.submit([1], priority="urgent")
