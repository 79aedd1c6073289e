"""PyTorch port vs JAX: the cost ledger (``repro_torch.obs.costs``),
mirroring ``tests/test_costs.py``.

* **The tables.**  ``decode_step_costs``, ``prefill_chunk_costs`` and
  ``fork_cost`` built from each package's live parameters (JAX
  ``init_params`` on reduced qwen2.5-3b in float32, the port's copy
  through ``params_from_numpy``, both engine-quantized at
  ``weight_bits=4`` or dense) are equal op by op, FLOPs and bytes, at
  kv_bits 0 and 8: the port's list of layers folds into the JAX package's
  stacked specs (``gemv/layers/attn/wq`` … with ``stack = n_layers``).
  The port's ``cuda`` attention backend prices as the JAX package's fused
  kernel (``pallas_tpu``); the JAX names are refused.
* **Honesty.**  On two small dense shapes, kv_bits 0 / 8, the GEMM FLOPs
  that ``torch.utils.flop_counter.FlopCounterMode`` counts over the
  port's plain ``decode_step_paged`` and ``prefill_chunk`` (``eng=None``,
  ``gather``) match the model's dot FLOPs (every linear's 2·K·N a token,
  the attention's q·K and p·V over the padded view) within ``TOL`` = 5%,
  JAX's tolerance against XLA's compiled costs.
* **The whole table** (JAX's contract, ``tests/test_costs.py``): the
  ledger's total FLOPs of a paged decode step and a chunk against the
  op counter's count (``roofline.counted_costs``) over the port's plain
  steps, within ``TOL``.
* **Attribution.**  A served engine charges every step; per-request rows
  sum to the totals; a chaos-retried request's recomputed work lands in
  ``wasted_flops``; the ledger equals the JAX engine's on the same
  traffic.
"""

import dataclasses

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.obs as jobs
from repro.ft import ChaosInjector as JaxChaosInjector
from repro.models import init_params
from repro.models import quantize_params as jax_quantize_params

import repro_torch.config as tconfig
from repro_torch.ft import ChaosInjector
from repro_torch.models import (
    decode_step_paged,
    init_params as torch_init_params,
    prefill_chunk,
    quantize_params,
)
from repro_torch.obs import NULL_TELEMETRY, Telemetry, costs
from repro_torch.serve import init_kv_pages
from repro_torch.weights import params_from_numpy

from conftest import reduced_f32
from test_torch_model import jax_params_to_numpy, torch_cfg
from test_torch_prefix_cache import make_engine

torch.set_num_threads(1)

SHAPES = [
    tconfig.ModelConfig(name="a", family="dense", n_layers=2, d_model=128,
                        n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
                        dtype="float32"),
    tconfig.ModelConfig(name="b", family="dense", n_layers=3, d_model=256,
                        n_heads=8, n_kv_heads=4, d_ff=512, vocab_size=1024,
                        dtype="float32"),
]
B, PAGE, NBLK, CHUNK = 4, 8, 4, 16
TOL = 0.05
PROMPTS = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10]]
JAX_BACKEND = {"gather": "gather", "cuda": "pallas_tpu"}


@pytest.fixture(scope="module")
def model():
    cfg = reduced_f32("qwen2.5-3b")
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    return cfg, params, tcfg, tparams


def _specs(model, weight_bits):
    cfg, params, tcfg, tparams = model
    if weight_bits:
        params = jax_quantize_params(params, cfg, weight_bits)
        tparams = quantize_params(tparams, tcfg, weight_bits)
    return jobs.linear_specs(params), costs.linear_specs(tparams)


def _table(c):
    return {op: (v.flops, v.bytes) for op, v in c.items()}


# ------------------------------------------------------ tables vs JAX
@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("weight_bits", [0, 4])
@pytest.mark.parametrize("backend", ["gather", "cuda"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_step_tables_equal_jax(model, kind, backend, weight_bits, kv_bits):
    cfg, _, tcfg, _ = model
    jspecs, tspecs = _specs(model, weight_bits)
    assert [dataclasses.asdict(s) for s in tspecs] == [
        dataclasses.asdict(s) for s in jspecs]
    assert all(s.stack == tcfg.n_layers for s in tspecs
               if s.name.startswith("layers/"))
    kw = dict(batch=3, context=21, page_size=4, kv_bits=kv_bits,
              weight_bits=weight_bits)
    if kind == "prefill":
        kw["chunk"] = 5
        fn, jfn = costs.prefill_chunk_costs, jobs.prefill_chunk_costs
    else:
        fn, jfn = costs.decode_step_costs, jobs.decode_step_costs
    port = fn(costs.model_dims(tcfg), attn_backend=backend, specs=tspecs,
              **kw)
    ref = jfn(jobs.model_dims(cfg), attn_backend=JAX_BACKEND[backend],
              specs=jspecs, **kw)
    assert _table(port) == _table(ref)
    assert "gemv/lm_head" in port and "gemv/layers/mlp/w_gate" in port


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_fork_cost_equals_jax(model, kv_bits):
    cfg, _, tcfg, _ = model
    port = costs.fork_cost(costs.model_dims(tcfg), page_size=4,
                           kv_bits=kv_bits)
    ref = jobs.fork_cost(jobs.model_dims(cfg), page_size=4, kv_bits=kv_bits)
    assert _table(port) == _table(ref)
    assert port["cow_fork"].bytes > 0 and port["cow_fork"].flops == 0


def test_attention_backends():
    """``cuda`` reads each mapped page once (the JAX fused kernel's
    model), ``gather`` three times; the JAX package's kernel names are
    not the port's."""
    kw = dict(n_kv_heads=2, head_dim=16, n_q_heads=4, page_size=4,
              kv_bits=8)
    for fn, jfn, extra in (
            (costs.decode_attn_bytes, jobs.costs.decode_attn_bytes, {}),
            (costs.prefill_attn_bytes, jobs.costs.prefill_attn_bytes,
             dict(chunk=3))):
        assert fn("cuda", batch=2, context=13, **extra, **kw) == jfn(
            "pallas_tpu", batch=2, context=13, **extra, **kw)
        assert fn("gather", batch=2, context=13, **extra, **kw) > fn(
            "cuda", batch=2, context=13, **extra, **kw)
        for name in ("pallas_tpu", "pallas_interpret", "triton"):
            with pytest.raises(ValueError, match="unknown attention"):
                fn(name, batch=2, context=13, **extra, **kw)


def test_tied_embedding_lm_head_synthesized(model):
    _, _, tcfg, tparams = model
    assert tcfg.tie_embeddings
    specs = costs.linear_specs(tparams)
    assert not any(s.name.endswith("lm_head") for s in specs)
    table = costs.decode_step_costs(costs.model_dims(tcfg), batch=2,
                                    context=32, page_size=4, specs=specs)
    assert table["gemv/lm_head"].flops > 0


def test_layer_list_must_agree():
    """Folding the layer list refuses layers whose linears differ."""
    a = {"attn": {"wq": {"w": torch.zeros(4, 8)}}}
    b = {"attn": {"wq": {"w": torch.zeros(4, 6)}}}
    assert costs.linear_specs({"layers": [a, a]})[0].stack == 2
    with pytest.raises(ValueError, match="differs"):
        costs.linear_specs({"layers": [a, b]})


# ------------------------------------------- modeled vs counted FLOPs
def _model_dot_flops(cfg, params, *, tokens, logit_tokens, chunk):
    """The model's dot FLOPs: 2·K·N a token of every linear (the lm_head
    on the logit tokens only) and q·K + p·V over the padded view."""
    dims = costs.model_dims(cfg)
    specs = costs._with_lm_head(dims, costs.linear_specs(params), 0)
    gemv = sum(2.0 * s.in_features * s.out_features * s.stack
               * (logit_tokens if s.name.endswith("lm_head") else tokens)
               for s in specs)
    attn = dims.n_layers * 4.0 * B * chunk * NBLK * PAGE * (
        dims.n_q_heads * dims.head_dim)
    return gemv + attn


def _counted(fn):
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("cfg", SHAPES, ids=lambda c: c.name)
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_dot_flops_match_flop_counter(kind, cfg, kv_bits):
    params = torch_init_params(cfg, torch.Generator().manual_seed(0))
    pages = init_kv_pages(cfg, B * NBLK + 1, PAGE, kv_bits=kv_bits,
                          device="cpu")
    bt = torch.arange(1, 1 + B * NBLK, dtype=torch.int32).reshape(B, NBLK)
    if kind == "decode":
        measured = _counted(lambda: decode_step_paged(
            params, pages, bt, torch.full((B,), 5, dtype=torch.int32),
            torch.ones((B,), dtype=torch.bool),
            torch.zeros((B, 1), dtype=torch.int32), cfg, None,
            attn_backend="gather"))
        modeled = _model_dot_flops(cfg, params, tokens=B, logit_tokens=B,
                                   chunk=1)
        whole = costs.total_cost(costs.decode_step_costs(
            costs.model_dims(cfg), batch=B, context=NBLK * PAGE,
            page_size=PAGE, kv_bits=kv_bits)).flops
    else:
        measured = _counted(lambda: prefill_chunk(
            params, pages, bt, torch.zeros((B, CHUNK), dtype=torch.int32),
            torch.zeros((B,), dtype=torch.int32),
            torch.full((B,), CHUNK, dtype=torch.int32), cfg, None,
            attn_backend="gather"))
        modeled = _model_dot_flops(cfg, params, tokens=B * CHUNK,
                                   logit_tokens=B, chunk=CHUNK)
        whole = costs.total_cost(costs.prefill_chunk_costs(
            costs.model_dims(cfg), batch=B, chunk=CHUNK,
            context=NBLK * PAGE, page_size=PAGE, kv_bits=kv_bits)).flops
    assert measured > 0
    ratio = modeled / measured
    assert 1 - TOL <= ratio <= 1 + TOL, (
        f"{kind} {cfg.name} kv{kv_bits}: modeled {modeled:.3e} vs "
        f"counted {measured:.3e} (ratio {ratio:.4f})")
    # the dots are most of the whole table's FLOPs at these shapes
    assert modeled <= whole <= 1.5 * modeled


@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("cfg", SHAPES, ids=lambda c: c.name)
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_table_flops_match_counted_costs(kind, cfg, kv_bits):
    from repro_torch.roofline import counted_costs

    params = torch_init_params(cfg, torch.Generator().manual_seed(0))
    pages = init_kv_pages(cfg, B * NBLK + 1, PAGE, kv_bits=kv_bits,
                          device="cpu")
    bt = torch.arange(1, 1 + B * NBLK, dtype=torch.int32).reshape(B, NBLK)
    eng = (tconfig.EngineConfig(kv_bits=8, backend="reference",
                                attn_backend="gather") if kv_bits else None)
    dims = costs.model_dims(cfg)
    if kind == "decode":
        measured = counted_costs(
            lambda: decode_step_paged(
                params, pages, bt, torch.full((B,), 5, dtype=torch.int32),
                torch.ones((B,), dtype=torch.bool),
                torch.zeros((B, 1), dtype=torch.int32), cfg, eng,
                attn_backend="gather"))["flops"]
        modeled = costs.total_cost(costs.decode_step_costs(
            dims, batch=B, context=NBLK * PAGE, page_size=PAGE,
            kv_bits=kv_bits)).flops
    else:
        measured = counted_costs(
            lambda: prefill_chunk(
                params, pages, bt, torch.zeros((B, CHUNK), dtype=torch.int32),
                torch.zeros((B,), dtype=torch.int32),
                torch.full((B,), CHUNK, dtype=torch.int32), cfg, eng,
                attn_backend="gather"))["flops"]
        modeled = costs.total_cost(costs.prefill_chunk_costs(
            dims, batch=B, chunk=CHUNK, context=NBLK * PAGE,
            page_size=PAGE, kv_bits=kv_bits)).flops
    assert measured > 0
    ratio = modeled / measured
    assert 1 - TOL <= ratio <= 1 + TOL, (
        f"{kind} {cfg.name} kv{kv_bits}: modeled {modeled:.3e} vs "
        f"counted {measured:.3e} (ratio {ratio:.4f})")


# ------------------------------------------------- ledger in the engine
def _engine(model, pkg, tel, *, chaos=None):
    return make_engine(model, pkg, max_new=5, n_slots=2, max_len=32,
                       page_size=4, prefill_chunk=3, audit=0,
                       max_request_retries=1, telemetry=tel, chaos=chaos)


def _serve(model, pkg, tel, chaos=None):
    eng = _engine(model, pkg, tel, chaos=chaos)
    for p in PROMPTS:
        eng.submit(list(p))
    done = eng.run()
    return eng, done


def test_ledger_charges_every_dispatch(model):
    eng, done = _serve(model, "torch", Telemetry(trace=False))
    assert all(r.done for r in done)
    m = eng.metrics()
    led = m["costs"]
    assert led["total_flops"] > 0 and led["total_bytes"] > 0
    ops = set(led["by_op"])
    assert {"attn_decode", "attn_prefill", "kv_write", "other"} <= ops
    assert "gemv/lm_head" in ops
    assert any(o.startswith("gemv/") and o != "gemv/lm_head" for o in ops)
    reqs = led["requests"]
    assert sorted(int(k) for k in reqs) == sorted(r.rid for r in done)
    tot_f = sum(row["flops"] for row in reqs.values())
    assert tot_f == pytest.approx(led["total_flops"], rel=1e-6)
    assert led["wasted_flops"] == 0
    counters = m["obs"]["metrics"]["counters"]
    flops_counters = {k: v for k, v in counters.items()
                      if k.startswith("serve_cost_flops_total")}
    assert sum(flops_counters.values()) == pytest.approx(
        led["total_flops"], rel=1e-6)
    ref, _ = _serve(model, "jax", jobs.Telemetry(trace=False))
    assert led == ref.metrics()["costs"]


def test_retry_waste_attributed_under_chaos(model):
    eng, done = _serve(model, "torch", Telemetry(trace=False),
                       ChaosInjector(seed=0, schedule={"step_fault": {1}}))
    assert all(r.done for r in done)
    m = eng.metrics()
    assert m["ft"]["retried"] >= 1
    assert m["ft"]["quarantined"] == 0
    assert m["ft"]["chaos"].get("step_fault", 0) >= 1
    led = m["costs"]
    assert led["wasted_flops"] > 0
    retried = [row for row in led["requests"].values()
               if row["retries"] > 0]
    assert retried and all(row["wasted_flops"] > 0 for row in retried)
    counters = m["obs"]["metrics"]["counters"]
    chaos_hits = sum(v for k, v in counters.items()
                     if k.startswith("serve_chaos_injected_total"))
    assert chaos_hits == sum(m["ft"]["chaos"].values())
    retry_hits = sum(v for k, v in counters.items()
                     if k.startswith("serve_retries_total"))
    assert retry_hits == m["ft"]["retried"]
    ref, _ = _serve(model, "jax", jobs.Telemetry(trace=False),
                    JaxChaosInjector(seed=0, schedule={"step_fault": {1}}))
    jm = ref.metrics()
    assert led == jm["costs"] and m["ft"] == jm["ft"]


def test_ledger_off_engine_reports_no_costs(model):
    eng, _ = _serve(model, "torch", NULL_TELEMETRY)
    m = eng.metrics()
    assert "costs" not in m and "obs" not in m
    assert m["ft"] == {"quarantined": 0, "retried": 0, "chaos": {}}
