"""PyTorch port vs JAX: snapshot / restore and chaos injection on a
``(data, model)`` mesh of ranks.

One spawned group of 8 ``gloo`` ranks (``test_torch_dist.RANK_PRELUDE``);
the ``(2, 2)``, ``(1, 2)`` and ``(2, 1)`` meshes are laid over the first
ranks (``make_mesh(ranks=)``).  Reduced qwen2.5-3b in float32 on JAX's
weights, the traffic of ``tests/test_snapshot.py`` (page 4, chunk 3,
max_len 32, 6 new tokens, its four prompts), every engine audited after
every phase (``ServeConfig(audit=2)``).

* The mesh recovery drill, the counterpart of ``tests/test_snapshot.py``
  ``test_recovery_drill_on_mesh``: at ``(4, 2)`` with the prefix cache
  (2 lanes, pages whole over data, KV heads over ``model``), kv 0 and 8,
  and at ``(2, 2)`` without it (4 lanes and the pool split over the data
  shards): run to step 3, snapshot on every rank, run on, restore into
  fresh rank engines, audit, run them out; at ``(2, 2)`` also through
  ``save_snapshot`` / ``load_snapshot``.  Tokens equal the
  uninterrupted mesh run's and JAX's single-device engine's, and every
  rank's snapshot is the same (but for each rank's own clock readings),
  at one device's pool shape.
* Across placements: the ``(2, 2)`` snapshot (which lists the second
  shard's null page free) restores into the port's single-device engine
  (that page joins its free list, its audit passes) and into JAX's
  single-device engine, both to the same tokens; a single-device snapshot restores into the ``(4, 2)`` engine
  (pages whole); a single-device snapshot whose lane maps a page outside
  that lane's shard range is refused by the ``(2, 2)`` engine with a
  ``ValueError`` naming the lane and the page.
* Chaos at ``(1, 2)`` and ``(2, 1)`` (lanes over data) under a fixed
  schedule that fires ``page_grant``, ``step_fault``, ``nan_logits`` and
  ``preempt_storm``: every rank's injector log, tokens, finish reasons,
  retries, quarantines and ``metrics()["ft"]`` equal the port's
  single-device run's (which ``test_torch_chaos.py`` holds to JAX's).  A
  faulted lane's pages are zeroed on the data shard that holds them, at
  its local ids, and nowhere else.
"""

import jax
import numpy as np
import pytest
import torch

from repro.models import init_params

from repro_torch.ft import ChaosInjector
from repro_torch.weights import params_from_numpy

from conftest import reduced_f32
from test_torch_mesh_train import _start_ranks
from test_torch_model import jax_params_to_numpy, torch_cfg
from test_torch_prefix_cache import make_engine

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [4], [5, 6, 1, 2, 3, 4, 5], [1, 2, 3, 4, 9]]
MESHES = {"4x2": ((4, 2), None), "2x2": ((2, 2), [0, 1, 2, 3]),
          "1x2": ((1, 2), [0, 1]), "2x1": ((2, 1), [0, 1])}
ENGINE = dict(max_len=32, page_size=4, prefill_chunk=3)
# name -> (mesh, engine options)
DRILLS = {"prefix_kv0": ("4x2", dict(n_slots=2, prefix_cache=True)),
          "prefix_kv8": ("4x2", dict(n_slots=2, prefix_cache=True,
                                     kv_bits=8)),
          "lanes": ("2x2", dict(n_slots=4))}
KILL_AT = 3
# the lane-sharded pool: 4 x 8 + 1 pages, padded to 34 for two shards
LANE_PAGES = 34
CHAOS = dict(seed=3, schedule={"page_grant": {2}, "step_fault": {1, 6},
                               "nan_logits": {3, 4},
                               "preempt_storm": {5}})
CHAOS_ENGINE = dict(n_slots=2, max_new=5, max_request_retries=1)


@pytest.fixture(scope="module")
def model():
    cfg = reduced_f32("qwen2.5-3b")
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    return cfg, params, tcfg, params_from_numpy(
        jax_params_to_numpy(params), tcfg, device="cpu")


RANK_CODE = """
import repro_torch.config as tconfig
from repro_torch.ft import ChaosInjector
from repro_torch.serve import ServeEngine

case = torch.load(os.path.join(OUT, "case.pt"), weights_only=False)
cfg, params = case["model"]
meshes = {label: make_mesh(shape, ("data", "model"), device="cpu",
                           ranks=ranks)
          for label, (shape, ranks) in case["meshes"].items()}
out = {"drill": {}, "chaos": {}}


def engine(mesh, n_slots, kv_bits=0, prefix_cache=False, max_new=6,
           chaos=None, max_request_retries=0, n_pages=None):
    scfg = tconfig.ServeConfig(
        max_new_tokens=max_new, audit=2,
        max_request_retries=max_request_retries,
        engine=tconfig.EngineConfig(kv_bits=kv_bits))
    return ServeEngine(cfg, params, scfg, n_slots=n_slots, mode="paged",
                       attn_backend="gather", device="cpu",
                       cuda_graphs=False, prefix_cache=prefix_cache,
                       chaos=chaos, mesh=mesh, n_pages=n_pages,
                       **case["engine"])


def drain(eng):
    return {r.rid: list(r.output) for r in eng.run()}


for name, (label, kw) in case["drills"].items():
    mesh = meshes[label]
    if mesh is None:
        continue
    a = engine(mesh, **kw)
    for p in case["prompts"]:
        a.submit(list(p))
    for _ in range(case["kill_at"]):
        a.step()
    snap = a.snapshot()
    ref = drain(a)
    b = engine(mesh, **kw)
    b.restore(snap)
    b.audit()
    rec = dict(ref=ref, got=drain(b), layout=b.mesh_layout,
               pool=tuple(b.pages.k.shape), snap=snap)
    if name == "lanes":   # through disk, on a mesh over part of the world
        directory = os.path.join(OUT, "snapshot_" + name)
        a2 = engine(mesh, **kw)
        for p in case["prompts"]:
            a2.submit(list(p))
        for _ in range(case["kill_at"]):
            a2.step()
        a2.save_snapshot(directory, case["kill_at"])
        d = engine(mesh, **kw)
        d.load_snapshot(directory)
        d.audit()
        rec["from_disk"] = drain(d)
    if "restore_in" in case and name in case["restore_in"]:
        c = engine(mesh, **kw)
        c.restore(case["restore_in"][name])
        c.audit()
        rec["from_one_device"] = drain(c)
    out["drill"][name] = rec

# a single-device snapshot whose lanes map pages outside their shard
mesh = meshes["2x2"]
if mesh is not None:
    eng = engine(mesh, n_slots=4)
    try:
        eng.restore(case["out_of_range"])
    except ValueError as e:
        out["refused"] = str(e)
    eng.audit()

for label in ("1x2", "2x1"):
    mesh = meshes[label]
    if mesh is None:
        continue
    chaos = ChaosInjector(**case["chaos"])
    eng = engine(mesh, chaos=chaos, **case["chaos_engine"])
    for p in case["prompts"]:
        eng.submit(list(p))
    done = eng.run()
    rec = dict(tokens={r.rid: list(r.output) for r in done},
               reasons={r.rid: r.finish_reason for r in done},
               retries={r.rid: r.retries for r in done},
               retried=eng.retried, quarantined=eng.quarantined,
               log=list(chaos.log), ft=eng.metrics()["ft"],
               layout=eng.mesh_layout)
    # scrub a lane of the first data shard by hand, on a fresh engine
    # after its first step
    eng = engine(mesh, n_slots=2)
    for p in case["prompts"]:
        eng.submit(list(p))
    eng.step()
    before = eng.pages.k.clone()
    private = [p for p in eng.alloc._mapped[0]
               if eng.alloc.refcount[p] == 1]
    eng._scrub_slot_pages(0)
    rec["scrub"] = dict(before=before, after=eng.pages.k.clone(),
                        private=private, lane_shard=eng._lane_shard,
                        shard_pages=getattr(eng.alloc, "shard_pages", None))
    out["chaos"][label] = rec
put(out)
"""


def _port_engine(model, **kw):
    return make_engine(model, "torch", max_new=kw.pop("max_new", 6), **ENGINE,
                       **kw)


def _drain(eng):
    return {r.rid: list(r.output) for r in eng.run()}


def _single_snapshot(model, **kw):
    """Run the port's single-device engine to ``KILL_AT`` and snapshot."""
    eng = _port_engine(model, **kw)
    for p in PROMPTS:
        eng.submit(list(p))
    for _ in range(KILL_AT):
        eng.step()
    return eng.snapshot()


def _chaos_single(model):
    chaos = ChaosInjector(**CHAOS)
    kw = dict(CHAOS_ENGINE)
    eng = make_engine(model, "torch", max_new=kw.pop("max_new"),
                      chaos=chaos, **ENGINE, **kw)
    for p in PROMPTS:
        eng.submit(list(p))
    done = eng.run()
    return dict(tokens={r.rid: list(r.output) for r in done},
                reasons={r.rid: r.finish_reason for r in done},
                retries={r.rid: r.retries for r in done},
                retried=eng.retried, quarantined=eng.quarantined,
                log=list(chaos.log), ft=eng.metrics()["ft"])


@pytest.fixture(scope="module")
def run(model, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serve_ft")
    _, _, tcfg, tparams = model
    # the single-device snapshot the (4, 2) prefix engine restores, and
    # one whose lanes map pages outside the (2, 2) shards' ranges
    from_one = _single_snapshot(model, n_slots=2, prefix_cache=True)
    out_of_range = _single_snapshot(model, n_slots=4, n_pages=LANE_PAGES)
    torch.save({"model": (tcfg, tparams), "meshes": MESHES,
                "engine": ENGINE, "drills": DRILLS, "prompts": PROMPTS,
                "kill_at": KILL_AT, "restore_in": {"prefix_kv0": from_one},
                "out_of_range": out_of_range, "chaos": CHAOS,
                "chaos_engine": CHAOS_ENGINE}, tmp / "case.pt")
    finish = _start_ranks(tmp, 8, RANK_CODE)
    refs = {"jax": {}, "chaos": _chaos_single(model)}
    for name, (_, kw) in DRILLS.items():
        jeng = make_engine(model, "jax", max_new=6, **ENGINE, **kw)
        for p in PROMPTS:
            jeng.submit(list(p))
        refs["jax"][name] = _drain(jeng)
    return finish(300), refs, out_of_range


def _members(label):
    ranks = MESHES[label][1]
    return list(range(8)) if ranks is None else ranks


@pytest.mark.parametrize("name", list(DRILLS))
def test_mesh_recovery_drill_gives_jax_tokens(run, name):
    res, refs, _ = run
    label = DRILLS[name][0]
    want = refs["jax"][name]
    for r in _members(label):
        d = res[r]["drill"][name]
        assert d["ref"] == want, (name, r)
        assert d["got"] == want, (name, r)
    if name == "lanes":
        for r in _members(label):
            assert res[r]["drill"][name]["from_disk"] == want, r
    lead = res[0]["drill"][name]
    if name.startswith("prefix"):
        assert lead["layout"]["whole_over_data"]
        assert lead["pool"][3] == 1                   # 2 KV heads over 2
    else:
        assert lead["layout"]["data_shards"] == 2
        assert lead["pool"][1] == LANE_PAGES // 2
    # every rank took the same snapshot, at one device's pool shape
    snap = lead["snap"]
    assert snap["arrays"]["pages/k"].shape[1] == snap["host"][
        "geometry"]["n_pages"]
    assert snap["arrays"]["pages/k"].shape[3] == 2
    for r in _members(label)[1:]:
        other = res[r]["drill"][name]["snap"]
        assert _timeless(other["host"]) == _timeless(snap["host"])
        for k, a in snap["arrays"].items():
            b = other["arrays"][k]
            assert (torch.equal(a, b) if torch.is_tensor(a)
                    else np.array_equal(a, b)), (name, r, k)


def _timeless(host):
    """A snapshot's host state without the requests' clock readings (each
    rank reads its own clock)."""
    return dict(host, requests=[
        {k: v for k, v in r.items() if k not in ("submit_t", "ttft")}
        for r in host["requests"]])


def test_mesh_snapshot_restores_into_one_device(run, model):
    """The lane-sharded ``(2, 2)`` snapshot into the port's single-device
    engine: its free list takes the second shard's null page, its audit
    passes and it runs out to the mesh's tokens."""
    res, refs, _ = run
    snap = res[0]["drill"]["lanes"]["snap"]
    eng = _port_engine(model, n_slots=4, n_pages=LANE_PAGES)
    eng.restore(snap)
    eng.audit()
    assert LANE_PAGES // 2 in eng.alloc.free
    assert _drain(eng) == refs["jax"]["lanes"]


def test_mesh_snapshot_restores_into_jax(run, model):
    """The same snapshot into JAX's single-device engine (which keeps its
    own PRNG key; greedy decoding reads none) gives the same tokens."""
    res, refs, _ = run
    snap = res[0]["drill"]["lanes"]["snap"]
    jeng = make_engine(model, "jax", max_new=6, n_slots=4,
                       n_pages=LANE_PAGES, **ENGINE)
    arrays = {k: np.asarray(v) for k, v in snap["arrays"].items()}
    arrays["key"] = np.asarray(jeng.key)
    jeng.restore({"arrays": arrays, "host": snap["host"]})
    jeng.audit()
    assert _drain(jeng) == refs["jax"]["lanes"]


def test_one_device_snapshot_restores_into_a_mesh(run):
    res, refs, _ = run
    for r in range(8):
        assert res[r]["drill"]["prefix_kv0"]["from_one_device"] == \
            refs["jax"]["prefix_kv0"], r


def test_snapshot_outside_a_shard_range_is_refused(run):
    res, _, snap = run
    msg = res[0]["refused"]
    lane, page = next((s, p) for s, m in enumerate(snap["host"]["alloc"][
        "mapped"]) for p in m if p // (LANE_PAGES // 2) != s // 2)
    assert f"lane {lane} maps page {page}" in msg
    assert all(res[r]["refused"] == msg for r in range(4))


@pytest.mark.parametrize("label", ["1x2", "2x1"])
def test_chaos_on_a_mesh_matches_one_device(run, label):
    res, refs, _ = run
    want = refs["chaos"]
    fired = {site for site, _ in want["log"]}
    assert fired == {"page_grant", "step_fault", "nan_logits",
                     "preempt_storm"}
    assert want["quarantined"] >= 1 and want["retried"] >= 1
    for r in _members(label):
        got = dict(res[r]["chaos"][label])
        assert got.pop("layout")["data_shards"] == (2 if label == "2x1"
                                                    else 1)
        got.pop("scrub")
        assert got == want, (label, r)


@pytest.mark.parametrize("label", ["1x2", "2x1"])
def test_scrub_zeroes_the_owning_shard_only(run, label):
    res, _, _ = run
    for r in _members(label):
        s = res[r]["chaos"][label]["scrub"]
        before, after = s["before"], s["after"]
        assert s["private"]
        if s["lane_shard"] is None:
            local = s["private"]
        elif s["lane_shard"] == 0:
            local = [p - 0 * s["shard_pages"] for p in s["private"]]
        else:
            local = []                     # another shard holds the lane
        changed = [p for p in range(before.shape[1])
                   if not torch.equal(before[:, p], after[:, p])]
        assert sorted(changed) == sorted(p for p in local
                                         if before[:, p].abs().sum() > 0)
        for p in local:
            assert not after[:, p].any(), (label, r, p)
