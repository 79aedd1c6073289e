"""The metric readers' arithmetic on synthetic records: a rate is every
token over the window, a percentile is over every gap, a stall in the
window moves both, and the shares price what the steps did."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

from servebench import costs, harness
from servebench.client import Record, StepRecord
from servebench.traffic import Spec
from servebench.window import Run, percentile

ROOT = Path(__file__).resolve().parents[1]
MODEL = json.loads((ROOT / "servebench" / "configs"
                    / "starcoder2-15b.json").read_text())
SERVE = {"lanes": 8, "prefill_chunk": 32, "max_len": 4096}


def read(name, run):
    return harness.reader(ROOT, name)(run)


def make_run(streams, t0=0.0, t1=10.0, steps=(), profile=None,
             records_extra=(), cache=None):
    """``streams``: per request (due, token stamps[, finish_reason])."""
    records = []
    for due, stamps, *reason in streams:
        req = SimpleNamespace(prompt=[0] * 10, output=[1] * len(stamps),
                              finish_reason=reason[0] if reason else None,
                              cached_tokens=0)
        records.append(Record(Spec([0] * 10, len(stamps)), req, due, due,
                              list(stamps)))
    records.extend(records_extra)
    steps = list(steps)
    client = SimpleNamespace(records=records, steps=steps,
                             eng=SimpleNamespace(prefix_cache=cache))
    return Run(client, {"t0": t0, "t1": t1, "first_step": 0,
                        "last_step": len(steps)},
               MODEL["model"], MODEL["engine"], SERVE, 12.5, 3 * 2 ** 30,
               profile, harness.family_of(ROOT, MODEL))


def steady(n_req=8, period=0.05, t1=10.0):
    return [(-1.0, [i * 0.001 + k * period
                    for k in range(1, int(t1 / period) + 1)])
            for i in range(n_req)]


def test_rate_is_every_token_over_the_window():
    run = make_run(steady())
    # tokens outside the window do not count; the window's seconds do
    before = make_run(steady() + [(-5.0, [-4.0, -3.0, 10.5])])
    n = sum(0 < t <= 10.0 for _, stamps in steady() for t in stamps)
    assert n == 200 + 7 * 199
    assert read("output_tok_s", run) == pytest.approx(n / 10.0)
    assert read("output_tok_s", before) == read("output_tok_s", run)


def test_p99_over_every_gap():
    gaps = [0.05] * 990 + [0.5] * 10
    stamps = [sum(gaps[:k + 1]) for k in range(len(gaps))]
    run = make_run([(-1.0, [t / 100.0 for t in stamps])], t1=1e3)
    assert read("itl_p99_ms", run) == pytest.approx(5.0, rel=1e-9)
    assert percentile(list(range(1, 101)), 99) == 99
    assert percentile([3.0], 99) == 3.0


def test_a_stall_moves_rate_and_tail():
    base = steady()
    stalled = [(due, [t if t < 5.0 else t + 0.8 for t in stamps])
               for due, stamps in base]
    a, b = make_run(base), make_run(stalled)
    assert read("output_tok_s", b) < read("output_tok_s", a)
    assert read("itl_p99_ms", a) == pytest.approx(50.0)
    # one gap of 0.85 s a request: under 1% of gaps, so p99 stays; four
    # stalls put it in the tail
    four = [(due, [t + 0.8 * sum(t >= s for s in (2, 4, 6, 8))
                   for t in stamps]) for due, stamps in base]
    assert read("itl_p99_ms", make_run(four)) == pytest.approx(850.0)


def test_ttft_counts_missing_requests():
    streams = [(k * 0.1, [k * 0.1 + 0.2]) for k in range(1, 91)]
    streams += [(9.5, [])] * 5 + [(1.0, [], "error")] * 5
    run = make_run(streams)
    assert run.ttfts().count(math.inf) == 10
    # the 90th percentile of 100: the 90th smallest, all finite
    assert read("ttft_p90_ms", run) == pytest.approx(200.0)
    streams += [(9.9, [])]
    assert read("ttft_p90_ms", make_run(streams)) is None


def test_pad_share_and_step_means():
    steps = [StepRecord(0.1 * k, 0.1 * k + 0.1, chunk=k % 2 == 0,
                        decode=True, chunk_s=0.06, decode_s=0.02,
                        prefill_rows=32 if k % 2 == 0 else 0)
             for k in range(10)]
    run = make_run(steady(), steps=steps)
    assert read("prefill_pad_share", run) == pytest.approx(
        100 * (1 - 32 / 256))
    assert read("decode_step_ms", run) == pytest.approx(20.0)
    assert read("prefill_chunk_ms", run) == pytest.approx(60.0)
    assert read("peak_mem_gib", run) == 3.0
    assert read("setup_s", run) == 12.5


def test_mfu_prices_each_token_at_its_position():
    m = MODEL["model"]
    steps = [StepRecord(0, 1, chunk=True, decode=True,
                        prefill_spans=[(100, 32)],
                        decode_positions=[500, 700])]
    run = make_run(steady(), steps=steps)
    flops = sum(2 * costs.matmul_params(m)
                + 4 * (p + 1) * m["n_heads"] * m["head_dim"] * m["n_layers"]
                for p in list(range(100, 132)) + [500, 700])
    assert read("mfu", run) == pytest.approx(100 * flops / (10 * 989e12))


def test_decode_hbm_share():
    m = MODEL["model"]
    steps = [StepRecord(0, 1, chunk=False, decode=True, decode_s=0.01,
                        decode_positions=[1000] * 8)] * 3
    run = make_run(steady(), steps=steps)
    kv = m["n_layers"] * 2 * (m["n_kv_heads"] * m["head_dim"]
                              + 2 * m["n_kv_heads"])
    codes = costs.decode_step_bytes(m, 4, 8, 8, [])
    want = 3 * (codes + 8 * 1001 * kv) / (0.03 * 3.35e12)
    assert read("decode_hbm_share", run) == pytest.approx(100 * want)


def test_route_rooflines_from_the_span():
    m = MODEL["model"]
    steps = [StepRecord(0, 1, chunk=False, decode=True),
             StepRecord(1, 2, chunk=True, decode=True),
             StepRecord(2, 3, chunk=False, decode=True)]
    n_lin = len(costs.layer_linears(m)) * m["n_layers"]

    def seen(dec, tc, dec_s, tc_s):
        return {"decode": {"seconds": dec_s, "launches": dec},
                "tensor_core": {"seconds": tc_s, "launches": tc}}

    # the third step's trace lost a decode launch: it is left out
    profile = {"steps": steps, "window_s": 2.0, "busy_s": 1.5,
               "step_routes": [seen(n_lin + 1, 0, 0.02, 0.0),
                               seen(n_lin + 2, n_lin, 0.03, 0.1),
                               seen(n_lin, 0, 0.02, 0.0)],
               "counted": {"bitplane_gemv/decode": 3 * (n_lin + 1) + 1,
                           "bitplane_gemv/tensor_core": n_lin}}
    run = make_run(steady(), steps=steps, profile=profile)
    bound = sum(costs.bound_s(costs.bitplane_gemv(8, k, n, 4, 2, 2))
                for _, k, n in costs.layer_linears(m)) * m["n_layers"]
    head = costs.bound_s(costs.bitplane_gemv(8, m["d_model"],
                                             m["vocab_size"], 4, 2, 2))
    # two decode steps' linears and heads, and the chunk step's head
    assert read("gemv_decode_roofline", run) == pytest.approx(
        100 * (2 * bound + 3 * head) / 0.05)
    tc_bound = sum(costs.bound_s(costs.bitplane_gemv(256, k, n, 4, 2, 2))
                   for _, k, n in costs.layer_linears(m)) * m["n_layers"]
    assert read("gemv_tc_roofline", run) == pytest.approx(
        100 * tc_bound / 0.1)
    assert read("device_idle_share", run) == pytest.approx(25.0)
    # the port counted other launches than the steps make
    profile["counted"]["bitplane_gemv/decode"] += 1
    assert read("gemv_decode_roofline", run) is None
    assert read("gemv_tc_roofline", make_run(steady(), steps=steps)) is None


def test_prefix_hit_share():
    recs = []
    for k, cached in enumerate((0, 96, 192)):
        req = SimpleNamespace(prompt=[0] * 200, output=[], cached_tokens=cached,
                              finish_reason=None)
        recs.append(Record(Spec([0] * 200, 4), req, 0.0, 0.0,
                           admitted=1.0 + k))
    run = make_run([], records_extra=recs, cache=object())
    assert read("prefix_hit_share", run) == pytest.approx(100 * 288 / 600)
    assert read("prefix_hit_share", make_run([], records_extra=recs)) is None
