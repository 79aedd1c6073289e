"""The traffic generator: determinism by seed, the same sizes for every
seed, the residual first request, sharing and the open loops."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from servebench.traffic import Traffic, residual_lengths, zipf_counts

HERE = Path(__file__).resolve().parent
MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))
SEEDS = (0, 2 ** 31 + 12345, 987654321987)


def mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def sizes(t):
    specs = [s for stream in t.streams for s in stream] + t.arrivals
    return Counter((len(s.prompt), s.max_new, s.first) for s in specs)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = (Traffic(mix(name), 32768, 4096, SEEDS[1]) for _ in range(2))
    assert [[(s.prompt, s.max_new) for s in st] for st in a.streams] == \
        [[(s.prompt, s.max_new) for s in st] for st in b.streams]
    assert [(s.prompt, s.max_new) for s in a.warm] == \
        [(s.prompt, s.max_new) for s in b.warm]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_sends_the_same_work(name):
    runs = [Traffic(mix(name), 32768, 4096, s) for s in SEEDS]
    order = [[(len(s.prompt), s.max_new, s.first, s.context)
              for st in t.streams for s in st] for t in runs]
    assert order[0] == order[1] == order[2]
    # ... with other tokens
    assert runs[0].streams[0][1].prompt != runs[1].streams[0][1].prompt
    assert runs[1].streams[3][0].prompt != runs[2].streams[3][0].prompt


@pytest.mark.parametrize("name", MIXES)
def test_requests_fit_max_len(name):
    t = Traffic(mix(name), 32768, 4096, SEEDS[0])
    m = mix(name)
    for stream in t.streams:
        assert stream[0].first and not any(s.first for s in stream[1:])
        for s in stream:
            assert 1 <= s.max_new and len(s.prompt) + s.max_new <= 4094
            assert all(0 <= tok < 32768 for tok in s.prompt[:64])
            if not s.first:
                assert s.max_new >= min(m["output"]["min"],
                                        4094 - len(s.prompt))
    assert len(t.streams) == m["clients"]


def test_residual_first_request():
    spec = {"dist": "lognormal", "median": 1024, "sigma": 0.5,
            "min": 256, "max": 3072}
    rng = np.random.default_rng(0)
    res = residual_lengths(spec, 20000, rng)
    full = np.clip(np.random.default_rng(1).lognormal(np.log(1024), 0.5,
                                                      200000), 256, 3072)
    # a lane at a random moment serves E[L^2] / E[L] on average, half of
    # which is still to come
    want = (full ** 2).mean() / full.mean() / 2
    assert abs(res.mean() / want - 1) < 0.03
    assert res.min() >= 1 and res.max() <= 3072
    assert (res < 256).mean() > 0.05   # residuals run below the minimum


def test_shared_contexts_zipf_and_warm():
    t = Traffic(mix("repo-prefix"), 49152, 4096, SEEDS[0])
    assert len(t.warm) == 8 and all(s.max_new == 1 for s in t.warm)
    specs = [s for st in t.streams for s in st]
    counts = Counter(s.context for s in specs)
    assert sorted(counts.values(), reverse=True) == \
        sorted(zipf_counts(8, 1.1, len(specs)).tolist(), reverse=True)
    for s in specs:
        ctx = t.contexts[s.context]
        assert s.prompt[:len(ctx)] == ctx and len(s.prompt) > len(ctx)
    fresh = Traffic(mix("repo-unshared"), 49152, 4096, SEEDS[0])
    assert not fresh.warm
    heads = {tuple(s.prompt[:64]) for st in fresh.streams for s in st}
    assert len(heads) == sum(len(st) for st in fresh.streams)


def test_zipf_counts():
    c = zipf_counts(8, 1.1, 1000)
    assert c.sum() == 1000 and list(c) == sorted(c, reverse=True)
    assert c[0] / c[1] == pytest.approx(2 ** 1.1, rel=0.02)


@pytest.mark.parametrize("loop,cv", [("poisson", 1.0), ("gamma", 3.0)])
def test_open_loop_arrivals(loop, cv):
    m = dict(mix("repo-prefix"), loop=loop, rate=4.0, cv=cv)
    runs = [Traffic(m, 49152, 4096, s) for s in SEEDS]
    dues = [np.array([s.due for s in t.arrivals]) for t in runs]
    for d in dues:
        assert (np.diff(d) >= 0).all()
    np.testing.assert_array_equal(dues[0], dues[1])
    g = [np.diff(np.concatenate([[0.0], d])) for d in dues]
    # within three standard errors of the mean gap of a pool this size
    assert g[0].mean() == pytest.approx(0.25, rel=3 * cv / len(g[0]) ** 0.5)
    assert g[0].std() / g[0].mean() == pytest.approx(cv, rel=0.3)
    assert not runs[0].streams and sizes(runs[0]) == sizes(runs[1])
