"""PyTorch port vs JAX: crash-consistent ``ServeEngine.snapshot()`` /
``restore()`` and their disk form ``save_snapshot`` / ``load_snapshot``
(``repro_torch.ckpt``), mirroring ``tests/test_snapshot.py`` case for case
(its mesh case waits for the port's multi-GPU item) and the two restore
cases of ``tests/test_trace_chaos.py``.

The traffic is ``tests/test_snapshot.py``'s: reduced qwen2.5-3b in float32
on the JAX package's weights, 2 lanes, max_len 32, page 4, chunk 3, 6 new
tokens, four prompts with alternating priorities and tenants, every engine
audited after every phase (``make_engine`` of
``tests/test_torch_prefix_cache.py``).  The recovery drill: run to step k,
snapshot, run the original to the end, restore the snapshot into a fresh
engine (or into the original one, in place) and run it to the end.  Every
comparison is exact: greedy tokens identical to the uninterrupted run's
and to the JAX engine's on the same traffic, and a snapshot the JAX
engine saved, loaded by the port, continues to JAX's tokens.
"""

import dataclasses
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import load_checkpoint as j_load
from repro.models import init_params
from repro.obs import Telemetry as JaxTelemetry

from repro_torch.ft import ChaosInjector
from repro_torch.obs import Telemetry, spans, validate_trace
from repro_torch.weights import params_from_numpy

from conftest import reduced_f32
from test_torch_model import jax_params_to_numpy, torch_cfg
from test_torch_prefix_cache import make_engine

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [4], [5, 6, 1, 2, 3, 4, 5], [1, 2, 3, 4, 9]]


@pytest.fixture(scope="module")
def model():
    cfg = reduced_f32("qwen2.5-3b")
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    return cfg, params, tcfg, tparams


def _engine(model, pkg="torch", *, kv_bits=0, prefix_cache=False,
            sched="fcfs", max_new=6, n_pages=0, **kw):
    return make_engine(model, pkg, max_new=max_new, n_slots=2, max_len=32,
                       kv_bits=kv_bits, page_size=4, prefill_chunk=3,
                       n_pages=n_pages, prefix_cache=prefix_cache,
                       sched=sched, **kw)


def _submit_all(eng):
    for i, p in enumerate(PROMPTS):
        eng.submit(list(p), priority="interactive" if i % 2 else "batch",
                   tenant=f"t{i % 2}")


def _drain(eng):
    return {r.rid: list(r.output) for r in eng.run()}


def _jax_tokens(model, **kw):
    eng = _engine(model, "jax", **kw)
    _submit_all(eng)
    return _drain(eng)


# ------------------------------------------------------------- identity
@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_kill_at_step_k_restore_identical(model, kv_bits, prefix_cache):
    kw = dict(kv_bits=kv_bits, prefix_cache=prefix_cache)
    engA = _engine(model, **kw)
    _submit_all(engA)
    for _ in range(3):  # mid-prefill / early-decode crash point
        engA.step()
    snap = engA.snapshot()
    ref = _drain(engA)  # the uninterrupted run
    assert ref == _jax_tokens(model, **kw)

    engB = _engine(model, **kw)  # a fresh process stands in
    engB.restore(snap)
    engB.audit()
    assert _drain(engB) == ref
    if prefix_cache:
        assert engB.prefix_stats() == engA.prefix_stats()


def test_budget_scheduler_vtime_restored(model):
    """Fair-share virtual time is engine state: dropping it would reorder
    admissions after a restore."""
    engA = _engine(model, sched="budget", prefix_cache=True)
    _submit_all(engA)
    for _ in range(2):
        engA.step()
    snap = engA.snapshot()
    assert snap["host"]["sched"]["vtime"]
    vtime = dict(engA.sched._vtime)
    ref = _drain(engA)
    assert ref == _jax_tokens(model, sched="budget", prefix_cache=True)

    engB = _engine(model, sched="budget", prefix_cache=True)
    engB.restore(snap)
    assert engB.sched._vtime == vtime
    assert _drain(engB) == ref


def test_snapshot_excludes_terminal_requests(model):
    eng = _engine(model, max_new=2)
    done_req = eng.submit([7, 8])
    eng.run()
    assert done_req.done
    _submit_all(eng)
    eng.step()
    snap = eng.snapshot()
    rids = {r["rid"] for r in snap["host"]["requests"]}
    assert done_req.rid not in rids
    assert len(rids) == len(PROMPTS)


def test_every_pending_state_is_captured(model):
    """A snapshot taken while requests are queued, mid-chunked-prefill and
    decoding at once: each resumes from its exact position."""
    eng = _engine(model, prefix_cache=True)
    _submit_all(eng)
    eng.step()  # 2 lanes admitted, 2 queued, prefill chunk 1 done
    snap = eng.snapshot()
    states = {r["rid"]: r for r in snap["host"]["requests"]}
    assert any(r["prefill_pos"] > 0 for r in states.values())
    assert snap["host"]["sched"]["queue"]  # someone still waiting
    ref = _drain(eng)
    engB = _engine(model, prefix_cache=True)
    engB.restore(snap)
    assert _drain(engB) == ref


def test_snapshot_host_state_equals_jax(model):
    """At the same step both packages' snapshots hold the same host JSON
    (the geometry, the allocator, the requests, the scheduler, the
    cache's tree) and the same pool bytes; the port stores its
    generator's state where JAX stores its key."""
    snaps = {}
    for pkg in ("jax", "torch"):
        eng = _engine(model, pkg, kv_bits=8, prefix_cache=True)
        _submit_all(eng)
        for _ in range(4):
            eng.step()
        snaps[pkg] = eng.snapshot()
    jh, th = snaps["jax"]["host"], snaps["torch"]["host"]
    for r in jh["requests"] + th["requests"]:
        r.pop("submit_t")  # each engine's clock
        r.pop("ttft")
    assert th == jh
    ja, ta = snaps["jax"]["arrays"], snaps["torch"]["arrays"]
    assert set(ta) - {"generator"} == set(ja) - {"key"}
    assert ta["generator"].dtype == np.uint8
    for name in ("pages/k", "pages/v"):
        np.testing.assert_array_equal(ta[name].numpy(), np.asarray(ja[name]))
    for name in ("pages/k_scale", "pages/v_scale"):
        # both are bf16 of equal values, up to exp's last bit (ROADMAP)
        np.testing.assert_allclose(ta[name].float().numpy(),
                                   np.asarray(ja[name], np.float32),
                                   rtol=2 ** -7)


# ------------------------------------------------------------------ disk
def test_disk_roundtrip_and_latest(model, tmp_path):
    engA = _engine(model, prefix_cache=True)
    _submit_all(engA)
    engA.step()
    engA.save_snapshot(str(tmp_path), 1)
    for _ in range(2):
        engA.step()
    engA.save_snapshot(str(tmp_path), 3)
    ref = _drain(engA)

    engB = _engine(model, prefix_cache=True)
    assert engB.load_snapshot(str(tmp_path)) == 3  # latest committed
    engB.audit()
    assert _drain(engB) == ref

    engC = _engine(model, prefix_cache=True)
    assert engC.load_snapshot(str(tmp_path), step=1) == 1
    assert _drain(engC) == ref


def test_geometry_mismatch_rejected(model, tmp_path):
    engA = _engine(model)
    _submit_all(engA)
    engA.step()
    snap = engA.snapshot()

    engB = _engine(model, kv_bits=8)
    with pytest.raises(ValueError, match="geometry.*kv_bits"):
        engB.restore(snap)
    engC = _engine(model, n_pages=64)
    with pytest.raises(ValueError, match="geometry.*n_pages"):
        engC.restore(snap)

    engA.save_snapshot(str(tmp_path), 0)
    # a checkpoint directory that holds no snapshot is refused up front
    from repro_torch.ckpt import save_checkpoint

    other = tmp_path / "train"
    save_checkpoint(str(other), 5, {"w": np.zeros((2, 2), np.float32)})
    engD = _engine(model)
    with pytest.raises(ValueError, match="snapshot"):
        engD.load_snapshot(str(other))


def test_snapshot_is_a_copy_not_a_view(model):
    """Stepping the engine after ``snapshot()`` must not change the taken
    snapshot: the pool is updated in place."""
    eng = _engine(model)
    _submit_all(eng)
    eng.step()
    snap = eng.snapshot()
    k_before = snap["arrays"]["pages/k"].clone()
    logits_before = {k: v.copy() for k, v in snap["arrays"].items()
                     if k.startswith("logits/")}
    assert logits_before
    eng.run()
    assert not torch.equal(eng.pages.k, k_before)  # the pool moved on
    assert torch.equal(snap["arrays"]["pages/k"], k_before)
    for k, v in logits_before.items():
        np.testing.assert_array_equal(snap["arrays"][k], v)


# ------------------------------------------------------ in-place restore
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_restore_in_place_keeps_storage(model, kv_bits):
    """Restore into the engine that took the snapshot, after it stepped
    on: the pool, its scales and the lane buffers keep their storage (a
    captured step graph reads them by address), and the tokens are the
    uninterrupted run's."""
    eng = _engine(model, kv_bits=kv_bits, prefix_cache=True)
    _submit_all(eng)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    ptrs = {name: t.data_ptr() for name, t in eng._pool_tensors().items()}
    lane_ptrs = {k: v.data_ptr() for k, v in vars(eng.lanes).items()}
    queue, slot_req = eng.queue, eng.slot_req
    ref = _drain(eng)
    eng.restore(snap)
    eng.audit()
    assert eng.queue is queue and eng.slot_req is slot_req
    assert eng.queue is eng.sched.queue and eng.slot_req is eng.sched.slot_req
    assert _drain(eng) == ref
    assert {name: t.data_ptr()
            for name, t in eng._pool_tensors().items()} == ptrs
    assert {k: v.data_ptr() for k, v in vars(eng.lanes).items()} == lane_ptrs


def test_generator_state_restored(model):
    """Sampling state is engine state: with temperature sampling the
    restored engine draws the uninterrupted run's tokens."""
    kw = dict(prefix_cache=False)

    def sampling(eng):
        eng.scfg = dataclasses.replace(eng.scfg, temperature=1.0)
        return eng

    engA = sampling(_engine(model, **kw))
    _submit_all(engA)
    for _ in range(3):
        engA.step()
    snap = engA.snapshot()
    ref = _drain(engA)
    engB = sampling(_engine(model, **kw))
    engB.generator.manual_seed(1234)
    engB.restore(snap)
    assert _drain(engB) == ref


# ------------------------------------------------------- across packages
@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_jax_snapshot_restores_into_the_port(model, tmp_path, kv_bits,
                                             prefix_cache):
    """The JAX engine's ``save_snapshot`` at step k, loaded by the port's
    engine on the same params: the port runs to the end and gives JAX's
    uninterrupted greedy tokens (the JAX snapshot carries ``key`` and no
    ``generator``; greedy decoding reads neither)."""
    kw = dict(kv_bits=kv_bits, prefix_cache=prefix_cache)
    jeng = _engine(model, "jax", **kw)
    _submit_all(jeng)
    for _ in range(3):
        jeng.step()
    jeng.save_snapshot(str(tmp_path), 3)
    ref = _drain(jeng)

    teng = _engine(model, **kw)
    state = teng.generator.get_state()
    assert teng.load_snapshot(str(tmp_path)) == 3
    assert torch.equal(teng.generator.get_state(), state)
    teng.audit()
    assert _drain(teng) == ref


def test_jax_written_snapshot_without_zstandard(model, tmp_path,
                                                monkeypatch):
    """A JAX snapshot written raw (no zstandard, as on a host without it)
    loads into the port."""
    import repro.ckpt.checkpoint as jckpt

    monkeypatch.setattr(jckpt, "zstandard", None)
    jeng = _engine(model, "jax", kv_bits=8)
    _submit_all(jeng)
    jeng.step()
    jeng.save_snapshot(str(tmp_path), 1)
    ref = _drain(jeng)
    teng = _engine(model, kv_bits=8)
    teng.load_snapshot(str(tmp_path))
    assert _drain(teng) == ref


def test_port_snapshot_is_a_jax_checkpoint(model, tmp_path):
    """The port's ``save_snapshot`` is the JAX package's checkpoint
    format: JAX's ``load_checkpoint`` reads its arrays bit for bit."""
    eng = _engine(model, kv_bits=8)
    _submit_all(eng)
    eng.step()
    eng.save_snapshot(str(tmp_path), 2)
    snap = eng.snapshot()
    with open(os.path.join(tmp_path, "step_00000002",
                           "manifest_0.json")) as f:
        extra = json.load(f)["extra"]
    assert extra["kind"] == "serve-engine-snapshot"
    template = {n: np.zeros(s, dtype=(ml_dtypes.bfloat16 if d == "bfloat16"
                                      else np.dtype(d)))
                for n, (s, d) in extra["array_specs"].items()}
    arrays, _ = j_load(str(tmp_path), template, 2)
    assert set(arrays) == set(snap["arrays"])
    for name, a in snap["arrays"].items():
        got = np.asarray(arrays[name])
        if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.view(np.int16),
                                          a.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(got, np.asarray(a))


# ----------------------------------------- test_trace_chaos.py's restores
def _assert_all_terminal(tel):
    states = {rid: tl.state for rid, tl in tel.timelines.items()}
    bad = {rid: s for rid, s in states.items() if s not in spans.TERMINAL}
    assert not bad, f"non-terminal timelines after run: {bad}"
    return states


TRACE_PROMPTS = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10]]


def _traced(model, tel, chaos=None, pkg="torch"):
    return make_engine(model, pkg, max_new=5, n_slots=2, max_len=32,
                       page_size=4, prefill_chunk=3, audit=0,
                       max_request_retries=1, telemetry=tel, chaos=chaos)


def _kill_and_restore(model, pkg):
    """Engine A killed at step 3 with requests in flight, its abandoned
    timelines force-closed; engine B restores A's snapshot and runs to
    the end.  Returns B's telemetry, B's tokens and the in-flight rids."""
    tcls = JaxTelemetry if pkg == "jax" else Telemetry
    telA, telB = tcls(trace=True), tcls(trace=True)
    engA = _traced(model, telA, pkg=pkg)
    for p in TRACE_PROMPTS:
        engA.submit(list(p))
    for _ in range(3):  # mid-prefill / early-decode crash point
        engA.step()
    snap = engA.snapshot()
    in_flight = {r["rid"] for r in snap["host"]["requests"]}
    assert in_flight  # the crash point must strand requests
    assert telA.close_open_timelines() == len(in_flight)
    if pkg == "torch":
        validate_trace(telA.tracer.export())
    statesA = _assert_all_terminal(telA)
    assert all(statesA[rid] == spans.ERRORED for rid in in_flight)
    engB = _traced(model, telB, pkg=pkg)
    engB.restore(snap)
    assert set(telB.timelines) == in_flight
    assert (telB.registry.counter(
        "serve_requests_restored_total").value == len(in_flight))
    done = engB.run()
    assert {r.rid for r in done} == in_flight
    return telB, {r.rid: r.output for r in done}, in_flight


def test_trace_valid_across_kill_and_restore(model):
    """Kill engine A at step k with requests in flight; restore into a
    fresh engine B.  Both traces validate, A's abandoned timelines are
    force-closed, B's restored timelines run to terminal states, and the
    restore is counted; B's tokens and counters equal the JAX engine's in
    the same drill."""
    telB, out, in_flight = _kill_and_restore(model, "torch")
    validate_trace(telB.tracer.export())
    statesB = _assert_all_terminal(telB)
    assert all(statesB[rid] == spans.RETIRED for rid in in_flight)
    names = {(e["tid"], e["name"]) for e in telB.tracer.events}
    assert (1000, "restore") in names
    jtel, jout, _ = _kill_and_restore(model, "jax")
    assert out == jout
    assert telB.registry.to_dict()["counters"] == (
        jtel.registry.to_dict()["counters"])


def test_trace_valid_chaos_then_restore(model):
    """Seeded chaos during the run and a kill-at-k restore: the restored
    engine's trace (with its own chaos marks) validates and ends every
    span."""
    telA = Telemetry(trace=True)
    engA = _traced(model, telA,
                   ChaosInjector(seed=7, schedule={"step_fault": {1}}))
    for p in TRACE_PROMPTS:
        engA.submit(list(p))
    for _ in range(4):
        engA.step()
    snap = engA.snapshot()
    telA.close_open_timelines()
    validate_trace(telA.tracer.export())
    _assert_all_terminal(telA)

    telB = Telemetry(trace=True)
    engB = _traced(model, telB,
                   ChaosInjector(seed=7, schedule={"step_fault": {0}}))
    engB.restore(snap)
    done = engB.run()
    assert all(r.done or r.finish_reason == "error" for r in done)
    validate_trace(telB.tracer.export())
    _assert_all_terminal(telB)
    if engB.retried or engB.quarantined:
        assert (telB.registry.counter(
            "serve_chaos_injected_total", site="step_fault").value >= 1)


# ------------------------------------------------------------ moe family
@pytest.fixture(scope="module",
                params=["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"])
def moe_model(request):
    cfg = reduced_f32(request.param)
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    return cfg, params, tcfg, tparams


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_moe_engine_disk_roundtrip(moe_model, kv_bits, tmp_path):
    """A reduced MoE engine saved at step 3 and loaded by a fresh engine
    runs to the uninterrupted run's tokens, which are JAX's."""
    engA = _engine(moe_model, kv_bits=kv_bits, prefix_cache=True)
    _submit_all(engA)
    for _ in range(3):
        engA.step()
    engA.save_snapshot(str(tmp_path), 3)
    ref = _drain(engA)
    assert ref == _jax_tokens(moe_model, kv_bits=kv_bits, prefix_cache=True)
    engB = _engine(moe_model, kv_bits=kv_bits, prefix_cache=True)
    assert engB.load_snapshot(str(tmp_path)) == 3
    engB.audit()
    assert _drain(engB) == ref


# ---------------------------------------------------------- audio family
@pytest.fixture(scope="module")
def audio_model():
    cfg = reduced_f32("musicgen-medium")
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    return cfg, params, tcfg, tparams


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_audio_engine_snapshot_restores_tokens(audio_model, kv_bits,
                                               tmp_path):
    """A reduced musicgen engine (``(K, V)`` last logits in the snapshot's
    ``logits/<rid>`` arrays) snapshotted at step 3 and restored in place
    and, through disk, into a fresh engine runs to the uninterrupted
    run's tokens, which are JAX's."""
    kw = dict(kv_bits=kv_bits, prefix_cache=True)
    engA = _engine(audio_model, **kw)
    _submit_all(engA)
    for _ in range(3):
        engA.step()
    snap = engA.snapshot()
    logits = [a for name, a in snap["arrays"].items()
              if name.startswith("logits/")]
    assert logits and all(a.shape == (audio_model[2].n_codebooks,
                                      audio_model[2].vocab_size)
                          for a in logits)
    engA.save_snapshot(str(tmp_path), 3)
    ref = _drain(engA)
    assert ref == _jax_tokens(audio_model, **kw)
    engA.restore(snap)
    assert _drain(engA) == ref
    engB = _engine(audio_model, **kw)
    assert engB.load_snapshot(str(tmp_path)) == 3
    engB.audit()
    assert _drain(engB) == ref
