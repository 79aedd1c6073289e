"""PyTorch port vs JAX: the prefix cache (radix-tree KV reuse with
refcounted copy-on-write pages), mirroring ``tests/test_prefix_cache.py``.

The port's ``ServeEngine(prefix_cache=True)`` on the CPU (plain GEMV,
``gather`` attention; one case on the ``cuda`` backend, whose wrappers run
their plain versions for CPU tensors) against JAX
``ServeEngine(prefix_cache=True)`` (``backend="reference"``,
``attn_backend="gather"``) on reduced qwen2.5-3b in float32, both with
the weights of JAX ``init_params`` (``params_from_numpy``).  Greedy
tokens must equal JAX's and the port's own cold run, at full-page and
mid-page (copy-on-write) split points, kv_bits 0 and 8, after eviction
and under preemption; ``prefix_stats()``, ``prefill_computed`` and the
preemption count must equal JAX's.  With int8 KV pages each request's
final logits are held at ``KV8_TOL`` (``tests/test_torch_model.py``).
Every engine audits itself after each phase (``ServeConfig(audit=2)``).

The host-side tree and allocator run the same random operation lists
in both packages: the free list, refcounts, block tables, matches and
counters must be equal after every operation, and both packages' audits
must pass.
"""

import collections

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the container has no hypothesis
    from _hypothesis_shim import given, settings, strategies as st

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import EngineConfig as JaxEngineConfig
from repro.config.base import ServeConfig as JaxServeConfig
from repro.models import init_params
from repro.serve import PageAllocator as JaxPageAllocator
from repro.serve import PrefixCache as JaxPrefixCache
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import fork_tail_page as jax_fork_tail_page
from repro.serve import init_kv_pages as jax_init_kv_pages

import repro_torch.config as tconfig
from repro_torch.serve import (
    AuditError,
    PageAllocator,
    PrefixCache,
    ServeEngine,
    fork_tail_page,
    init_kv_pages,
)
from repro_torch.serve.pages import NULL_PAGE
from repro_torch.weights import params_from_numpy

from conftest import reduced_f32
from test_torch_model import KV8_TOL, jax_params_to_numpy, torch_cfg

torch.set_num_threads(1)

PS = 4  # page size of every engine in this file

# page size 4: A's pages cover [1..4][5..8][9..12]; B leaves A mid-page in
# its third page; C repeats A (the len - 1 cap leaves a 3-token fork of the
# last page); D shares nothing
A = list(range(1, 13))
B = list(range(1, 11)) + [60, 61]
C = list(A)
D = [71, 72, 73, 74, 75, 76, 77, 78, 79]


@pytest.fixture(scope="module")
def model():
    cfg = reduced_f32("qwen2.5-3b")
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    return cfg, params, tcfg, tparams


def make_engine(model, pkg, *, max_new=5, n_slots=1, max_len=32,
                kv_bits=0, attn_backend="gather", clock=None, **kw):
    """A paged engine of package ``pkg`` ("jax" or "torch") on the shared
    weights; ``kw`` splits into ``ServeConfig`` fields and engine
    arguments."""
    cfg, params, tcfg, tparams = model
    scfg_keys = ("sched", "step_tokens", "max_queue", "audit",
                 "max_request_retries", "retry_reset_steps")
    scfg_kw = {k: kw.pop(k) for k in scfg_keys if k in kw}
    scfg_kw.setdefault("audit", 2)
    if pkg == "jax":
        scfg = JaxServeConfig(
            max_new_tokens=max_new, engine=JaxEngineConfig(
                kv_bits=kv_bits, backend="reference"), **scfg_kw)
        return JaxServeEngine(cfg, params, scfg, n_slots=n_slots,
                              max_len=max_len, mode="paged",
                              attn_backend="gather", clock=clock, **kw)
    scfg = tconfig.ServeConfig(
        max_new_tokens=max_new, engine=tconfig.EngineConfig(kv_bits=kv_bits),
        **scfg_kw)
    return ServeEngine(tcfg, tparams, scfg, n_slots=n_slots, max_len=max_len,
                       mode="paged", attn_backend=attn_backend, clock=clock,
                       device="cpu", **kw)


def _gen(model, pkg, prompts, **kw):
    eng = make_engine(model, pkg, page_size=PS, **kw)
    for p in prompts:
        eng.submit(list(p))
    return eng, sorted(eng.run(), key=lambda r: r.rid)


def _hot_cold_jax(model, prompts, *, kv_bits=0, attn_backend="gather",
                  **kw):
    """JAX hot, port hot and port cold over the same prompts: tokens,
    stats, computed prefill and preemptions held equal; returns the three
    engines."""
    jeng, jreq = _gen(model, "jax", prompts, prefix_cache=True,
                      kv_bits=kv_bits, **kw)
    teng, treq = _gen(model, "torch", prompts, prefix_cache=True,
                      kv_bits=kv_bits, attn_backend=attn_backend, **kw)
    ceng, creq = _gen(model, "torch", prompts, prefix_cache=False,
                      kv_bits=kv_bits, attn_backend=attn_backend, **kw)
    assert len(treq) == len(prompts)
    for j, t, c in zip(jreq, treq, creq):
        assert t.output == j.output, ("jax", t.rid, t.output, j.output)
        assert t.output == c.output, ("cold", t.rid, t.output, c.output)
        assert t.cached_tokens == j.cached_tokens, t.rid
        if kv_bits:
            np.testing.assert_allclose(t.last_logits,
                                       np.asarray(j.last_logits), **KV8_TOL)
    assert teng.prefix_stats() == jeng.prefix_stats()
    assert teng.prefill_computed == jeng.prefill_computed
    assert teng.preemptions == jeng.sched.preemptions
    assert ceng.prefix_stats() is None
    teng.audit()
    return jeng, teng, ceng


# ---------------------------------------------------------------- identity
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_hits_match_jax_full_and_mid_page(model, kv_bits):
    _, teng, ceng = _hot_cold_jax(model, [A, B, C, D], kv_bits=kv_bits)
    st_ = teng.prefix_stats()
    # B matches 10 tokens (2 full pages + a 2-token fork), C is capped at
    # len - 1 = 11 (2 full pages + a 3-token fork)
    assert st_["hits"] == 2 and st_["cow_forks"] == 2, st_
    assert st_["hit_tokens"] == 10 + 11, st_
    assert teng.prefill_computed == ceng.prefill_computed - 21


def test_full_page_split_no_fork(model):
    base = list(range(1, 9))                     # 8 tokens = 2 full pages
    prompts = [base + [30 + i, 40 + i] for i in range(3)]
    _, teng, _ = _hot_cold_jax(model, prompts)
    st_ = teng.prefix_stats()
    assert st_["cow_forks"] == 0 and st_["hit_tokens"] == 2 * 8, st_


@pytest.mark.parametrize("n_slots,chunk", [(2, 1), (2, 5), (3, 2)])
def test_concurrent_lanes_and_chunk_sizes(model, n_slots, chunk):
    _hot_cold_jax(model, [A, B, C, D, B, A], n_slots=n_slots,
                  prefill_chunk=chunk)


def test_identity_after_eviction(model):
    _, teng, _ = _hot_cold_jax(model, [A, B, C, D, B, A], n_pages=9,
                               max_new=8)
    assert teng.prefix_cache.evicted_pages > 0
    # drained: every page is free or cached, no reference remains
    assert teng.alloc.used_pages == teng.prefix_cache.cached_pages
    assert teng.alloc.refcount.sum() == 0


def test_identity_under_preemption(model):
    _, teng, _ = _hot_cold_jax(model, [A, B, C, D], n_slots=3, max_len=48,
                               n_pages=14, max_new=16)
    assert teng.preemptions > 0


def test_kernel_route_surroundings_on_cpu(model):
    """The ``cuda`` attention backend on CPU tensors: its wrappers run the
    plain versions, with the kernel route's paging, padding and fork
    handling around them."""
    _, teng, _ = _hot_cold_jax(model, [A, B, C, D], kv_bits=8,
                               attn_backend="cuda", n_slots=2)
    assert teng.attn_backend == "cuda"


# ------------------------------------------------------------ fork in place
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_fork_tail_page_copies_in_place(model, kv_bits):
    cfg, _, tcfg, _ = model
    pages = init_kv_pages(tcfg, 5, PS, kv_bits=kv_bits, device="cpu")
    names = ["k", "v"] + (["k_scale", "v_scale"] if kv_bits else [])
    gen = torch.Generator().manual_seed(kv_bits)
    for name in names:
        t = getattr(pages, name)
        t.copy_(torch.randint(-100, 100, t.shape, generator=gen))
    ptrs = {n: getattr(pages, n).data_ptr() for n in names}
    before = {n: getattr(pages, n).clone() for n in names}
    jpages = jax_init_kv_pages(cfg, 5, PS, kv_bits=kv_bits)
    jpages = jpages.replace(**{
        n: jnp.asarray(before[n].float().numpy()).astype(
            getattr(jpages, n).dtype) for n in names})
    assert fork_tail_page(pages, 2, 4) is None
    jforked = jax_fork_tail_page(jpages, jnp.int32(2), jnp.int32(4))
    for n in names:
        t = getattr(pages, n)
        assert t.data_ptr() == ptrs[n], n
        assert torch.equal(t[:, 4], before[n][:, 2]), n
        # every layer, and no other page, changed
        keep = [0, 1, 2, 3]
        assert torch.equal(t[:, keep], before[n][:, keep]), n
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(getattr(jforked, n), np.float32))


# ---------------------------------------------------- tree against JAX
_OPS = st.lists(
    st.tuples(st.sampled_from(["ensure", "free", "insert", "evict",
                               "share", "fork"]),
              st.integers(0, 2),            # slot
              st.integers(1, 24)),          # token count / evict count
    min_size=1, max_size=40)


def _pair(n_pages=13, page_size=4, n_slots=3, max_len=24):
    out = []
    for alloc_cls, cache_cls in ((JaxPageAllocator, JaxPrefixCache),
                                 (PageAllocator, PrefixCache)):
        alloc = alloc_cls(n_pages, page_size, n_slots, max_len)
        out.append((alloc, cache_cls(alloc)))
    return out


def _apply(alloc, cache, op, slot, n, streams):
    """One operation; returns what it returned, for comparison."""
    if op == "ensure":
        return alloc.ensure(slot, min(n, 24))
    if op == "free":
        return alloc.free_slot(slot)
    if op == "insert":
        toks = streams[slot][:min(n, 4 * len(alloc._mapped[slot]))]
        return cache.insert(toks, alloc.block_row(slot))
    if op == "evict":
        return cache.evict(n % 4 + 1)
    m = cache.match(streams[slot][:n])
    got = ([int(p) for p in m.full_pages], m.partial, m.matched_tokens)
    if op == "share" and m.full_pages and not alloc._mapped[slot]:
        alloc.map_shared(slot, m.full_pages)
    if op == "fork" and m.partial and len(alloc._mapped[slot]) < 6:
        got += (alloc.alloc_page(slot),)
    return got


def _state(alloc, cache):
    return (list(alloc.free), alloc.refcount.tolist(),
            alloc.block_tables.tolist(), [list(m) for m in alloc._mapped],
            sorted(int(p) for p in cache.pages()), cache.stats(),
            cache._recount_evictable())


def _same_after_each(ops, streams, pair):
    (jalloc, jcache), (talloc, tcache) = pair
    for op, slot, n in ops:
        got_j = _apply(jalloc, jcache, op, slot, n, streams)
        got_t = _apply(talloc, tcache, op, slot, n, streams)
        assert got_t == got_j, (op, slot, n, got_t, got_j)
        assert _state(talloc, tcache) == _state(jalloc, jcache), (op, slot, n)
        for alloc, cache in pair:
            alloc.audit()
            cache.audit()
        assert (tcache.evictable_count() == tcache._recount_evictable())
        assert (talloc.refcount >= 0).all()
        assert NULL_PAGE not in talloc.free and not tcache.holds(NULL_PAGE)


@settings(max_examples=40, deadline=None)
@given(ops=_OPS)
def test_random_ops_match_jax(ops):
    streams = [[100 * (s + 1) + i for i in range(24)] for s in range(3)]
    _same_after_each(ops, streams, _pair())


@settings(max_examples=40, deadline=None)
@given(ops=_OPS)
def test_random_ops_on_shared_stream_match_jax(ops):
    """Two slots walk the same token stream, so shared pins hit interior
    nodes as well as leaves; drained at the end, both trees come back
    empty."""
    shared = [300 + i for i in range(24)]
    streams = [shared, shared, [900 + i for i in range(24)]]
    pair = _pair()
    _same_after_each(ops, streams, pair)
    drain = [("free", s, 1) for s in range(3)] + [("evict", 0, 11)] * 4
    _same_after_each(drain, streams, pair)
    for _, cache in pair:
        assert cache.cached_pages == 0 and cache.evictable_count() == 0


def test_match_insert_semantics():
    alloc = PageAllocator(n_pages=17, page_size=4, n_slots=2, max_len=32)
    cache = PrefixCache(alloc)
    assert alloc.ensure(0, 12)
    row = alloc.block_row(0)
    toks = list(range(100, 112))
    assert cache.insert(toks, row) == 3 and cache.cached_pages == 3
    m = cache.match(toks)
    assert [int(p) for p in m.full_pages] == [int(row[0]), int(row[1])]
    assert m.partial == (int(row[2]), 3) and m.matched_tokens == 11
    m2 = cache.match(toks[:10] + [7, 7])
    assert m2.partial == (int(row[2]), 2) and m2.matched_tokens == 10
    m3 = cache.match([1] + toks)
    assert not m3 and m3.matched_tokens == 0
    m4 = cache.match(toks[:4])
    assert m4.full_pages == [] and m4.partial == (int(row[0]), 3)
    assert cache.insert(toks, row) == 0
    assert alloc.ensure(1, 12)
    assert cache.insert(toks, alloc.block_row(1)) == 0
    assert cache.cached_pages == 3


def test_lru_evicts_least_recently_used_first():
    alloc = PageAllocator(n_pages=17, page_size=4, n_slots=2, max_len=32)
    cache = PrefixCache(alloc)
    old_toks, new_toks = [100 + i for i in range(8)], [500 + i
                                                       for i in range(8)]
    alloc.ensure(0, 9)
    cache.insert(old_toks, alloc.block_row(0))
    alloc.free_slot(0)
    alloc.ensure(1, 9)
    cache.insert(new_toks, alloc.block_row(1))
    alloc.free_slot(1)
    old_pages = cache.match(old_toks + [1]).full_pages
    new_pages = cache.match(new_toks + [1]).full_pages
    cache.match(old_toks + [7])           # the old chain is now the newest
    assert cache.evict(2) == 2
    assert all(cache.holds(int(p)) for p in old_pages)
    assert not any(cache.holds(int(p)) for p in new_pages)


def test_deep_chain_does_not_recurse():
    alloc = PageAllocator(n_pages=2102, page_size=4, n_slots=1,
                          max_len=8400)
    cache = PrefixCache(alloc)
    assert alloc.ensure(0, 2000 * 4)
    toks = list(range(2000 * 4))
    assert cache.insert(toks, alloc.block_row(0)) == 2000
    alloc.free_slot(0)
    assert cache.evictable_count() == 2000
    m = cache.match(toks)
    assert len(m.full_pages) == 1999 and m.partial[1] == 3
    assert alloc.can_allocate(2100)
    cache.audit()
    assert cache.evict(2000) == 2000
    assert alloc.free_pages == 2101


def test_eviction_skips_referenced_and_interior_pages():
    alloc = PageAllocator(n_pages=17, page_size=4, n_slots=2, max_len=32)
    cache = PrefixCache(alloc)
    assert alloc.ensure(0, 12)
    cache.insert(list(range(200, 212)), alloc.block_row(0))
    row = alloc.block_row(0)
    alloc.free_slot(0)
    assert cache.evictable_count() == 3
    alloc.map_shared(1, [int(row[0])])    # pins the root page only
    assert cache.evictable_count() == 2
    assert cache.evict(10) == 2
    assert cache.holds(int(row[0])) and alloc.refcount[int(row[0])] == 1
    alloc.free_slot(1)
    assert cache.evict(10) == 1 and cache.cached_pages == 0
    alloc.audit()


def test_null_page_never_granted_or_freed():
    alloc = PageAllocator(n_pages=5, page_size=2, n_slots=1, max_len=8)
    assert alloc.ensure(0, 8)
    assert NULL_PAGE not in alloc._mapped[0]
    with pytest.raises(ValueError):
        alloc._release_page(NULL_PAGE)
    alloc.free_slot(0)
    with pytest.raises(ValueError):
        alloc.map_shared(0, [NULL_PAGE])


def test_ensure_rolls_back_a_partial_grant():
    """A grant that runs dry part way (a page vanishing between the
    capacity check and the take) leaves the slot as it was."""
    alloc = PageAllocator(n_pages=9, page_size=4, n_slots=1, max_len=32)
    assert alloc.ensure(0, 4)
    before = (list(alloc.free), alloc.block_tables.copy())
    real_take, taken = alloc._take_page, []

    def take_twice():
        if len(taken) == 2:
            return None
        taken.append(real_take())
        return taken[-1]

    alloc._take_page = take_twice
    assert not alloc.ensure(0, 20)
    assert alloc._mapped[0] == [int(before[1][0, 0])]
    np.testing.assert_array_equal(alloc.block_tables, before[1])
    assert sorted(alloc.free) == sorted(before[0])
    alloc.audit()


# ---------------------------------------------------- options and audits
def test_prefix_cache_option_rules(model):
    _, _, tcfg, tparams = model
    with pytest.raises(TypeError, match="must be a bool"):
        ServeEngine(tcfg, tparams, n_slots=1, max_len=16, device="cpu",
                    prefix_cache=PrefixCache(PageAllocator(5, 4, 1, 16)))
    ssm = tconfig.get_reduced("mamba2-130m")
    with pytest.raises(ValueError, match="prefix_cache"):
        ServeEngine(ssm, None, n_slots=1, max_len=16, mode="slots",
                    prefix_cache=True, device="cpu")
    eng = ServeEngine(tcfg, tparams, tconfig.ServeConfig(prefix_cache=True),
                      n_slots=1, max_len=16, device="cpu")
    assert isinstance(eng.prefix_cache, PrefixCache)
    assert eng.alloc._cache is eng.prefix_cache
    off = ServeEngine(tcfg, tparams, tconfig.ServeConfig(prefix_cache=True),
                      n_slots=1, max_len=16, prefix_cache=False,
                      device="cpu")
    assert off.prefix_cache is None and off.prefix_stats() is None


def test_audit_passes_idle_cache_and_names_violations(model):
    eng, _ = _gen(model, "torch", [A, B, C], prefix_cache=True, n_slots=2,
                  audit=2)
    # idle cached pages are resident, not leaked
    assert eng.prefix_cache.cached_pages > 0 and eng.alloc.refcount.sum() == 0
    eng.audit()
    page = next(iter(eng.prefix_cache.pages()))
    eng.alloc.refcount[page] += 1
    with pytest.raises(AuditError, match="refcount"):
        eng.audit()
    eng.alloc.refcount[page] -= 1
    eng.prefix_cache._blocked += 1
    with pytest.raises(AuditError, match="_blocked"):
        eng.audit()
    eng.prefix_cache._blocked -= 1
    eng.sched.pending_forks.append((1, page, page))
    with pytest.raises(AuditError, match="pending fork"):
        eng.audit()
    eng.sched.pending_forks.clear()
    lost = eng.alloc.free.pop()
    with pytest.raises(AuditError, match="leaked"):
        eng.audit()
    eng.alloc.free.append(lost)
    eng.audit()


def test_audit_runs_in_step(model):
    """``ServeConfig(audit=1)`` audits after each step: a corruption made
    between steps stops the next one."""
    eng = make_engine(model, "torch", page_size=PS, prefix_cache=True,
                      audit=1)
    eng.submit(list(A))
    eng.step()
    # the bottom of the LIFO free list: the step takes no page from there
    eng.alloc.free.insert(0, eng.alloc.free[0])
    with pytest.raises(AuditError, match="duplicate"):
        eng.step()
    assert collections.Counter(eng.alloc.free).most_common(1)[0][1] == 2
