"""PyTorch port vs JAX: the ``sharded`` engine backend and paged serving on
a ``(data, model)`` mesh of ranks.

In one process: plan resolution with the mesh fields and their
validation, the backend's degrade to its wrapped backend without a mesh
(bit for bit), what a mesh refuses, and where the serving placement
departs from JAX's name-only ``param_shardings``.

On 8 ``gloo`` ranks (one spawned group, ``test_torch_dist.run_ranks``):

* the backend's ``bits × radix × {col, row}`` sweep on an 8-way model
  axis, with 1-D, 2-D and 3-D activations, on integer-grid data (every
  float32 product and partial sum exact), so the gathered output is bit
  for bit the port's unsharded plan's and JAX's ``reference`` backend's;
  and ``psum_bits=8`` within ``n·scale/2`` of the exact sum;
* paged serving of reduced qwen2.5-3b (float32, JAX's weights and
  prompts, ``page_size 4``, ``prefill_chunk 3``, ``max_len 32``) on
  ``(4, 2)``: greedy tokens equal to the port's unsharded engine's and to
  JAX's unsharded ``gather`` engine's at ``kv_bits`` 0 and 8, under
  preemption, through prefix-cache hits, with lanes and pages over data
  (preempting within a data shard), with ``weight_bits=8`` through the
  ``sharded`` backend, and on ``(2, 4)``, where the two KV heads do not
  divide the model axis and attention stays whole on every rank.  Held
  against ``gather``, not against JAX's ``pallas_interpret`` mesh test,
  which fails on this host (``ROADMAP.md`` queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import EngineConfig as JaxEngineConfig
from repro.config.base import ServeConfig as JaxServeConfig
from repro.engine import EnginePlan as JaxEnginePlan
from repro.engine import pack_linear as jax_pack_linear
from repro.models import init_params as jax_init_params
from repro.serve import ServeEngine as JaxServeEngine

import repro_torch.config as tconfig
from repro_torch.dist.sharding import param_shardings, serve_param_specs
from repro_torch.engine import EnginePlan, pack_linear, resolve_plan
from repro_torch.serve import ServeEngine
from repro_torch.weights import params_from_numpy

from conftest import reduced_f32
from test_torch_dist import StandIn, run_ranks
from test_torch_model import jax_params_to_numpy, torch_cfg

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10]]
PREFIX_PROMPTS = [list(range(1, 13)), list(range(1, 11)) + [99, 100],
                  list(range(1, 13))]
# eight lanes over four data shards: two lanes and ten pages a shard,
# where two 16-token requests cannot both stay resident
SHARD_PROMPTS = PROMPTS + [[11, 12], [13], [14, 15, 16], [17, 18, 19, 20]]


def grid_data(b, k, n, bits, seed=0):
    """Integer-grid (w, x): quantizes exactly, scale = 2^-3."""
    qmax = 2 ** (bits - 1) - 1
    rng = np.random.default_rng(seed)
    q = rng.integers(-qmax, qmax + 1, (k, n)).astype(np.float32)
    q[0, :] = qmax   # pin per-column absmax -> scale exactly 2^-3
    x = rng.integers(-8, 9, (b, k)).astype(np.float32)
    return q * 2.0 ** -3, x


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


def test_sharded_plan_from_config():
    """``EngineConfig(sharded=True)`` wraps the named backend: the plan's
    backend is ``sharded`` and the configured one its inner backend."""
    plan = resolve_plan(tconfig.EngineConfig(
        weight_bits=8, backend="reference", sharded=True, psum_bits=8),
        device="cpu")
    assert (plan.backend, plan.inner_backend) == ("sharded", "reference")
    assert plan.psum_bits == 8 and plan.mesh is None
    auto = resolve_plan(tconfig.EngineConfig(weight_bits=4, sharded=True),
                        device="cpu")
    assert (auto.backend, auto.inner_backend) == ("sharded", "reference")
    mesh = StandIn((2, 4), ("data", "model"))
    assert resolve_plan(tconfig.EngineConfig(weight_bits=4, sharded=True),
                        device="cpu", mesh=mesh).mesh is mesh


def test_sharded_plan_validation():
    with pytest.raises(KeyError):
        EnginePlan(backend="sharded", bits=8, inner_backend="no_such")
    with pytest.raises(ValueError):
        EnginePlan(backend="sharded", bits=8, inner_backend="sharded")
    with pytest.raises(ValueError):
        EnginePlan(backend="reference", bits=8, psum_bits=5)
    with pytest.raises(ValueError):
        tconfig.EngineConfig(psum_bits=3)
    with pytest.raises(ValueError, match="model_axis"):
        EnginePlan(backend="sharded", bits=8, inner_backend="reference",
                   mesh=StandIn((8,), ("data",)))


@pytest.mark.parametrize("inner", ["reference", "bit_serial"])
def test_sharded_degrades_without_mesh(inner):
    """No mesh on the plan, or a whole weight: the wrapped backend runs
    as it is, bit for bit, and equals JAX's sharded plan there (integer
    grid data: every product exact)."""
    w, x = grid_data(2, 64, 16, 8, seed=3)
    lin = pack_linear(torch.from_numpy(w), 8)
    xt = torch.from_numpy(x)
    ref = EnginePlan(backend=inner, bits=8).apply(lin, xt)
    for mesh in (None, StandIn((1, 8), ("data", "model"))):
        sh = EnginePlan(backend="sharded", bits=8, inner_backend=inner,
                        mesh=mesh).apply(lin, xt)
        torch.testing.assert_close(sh, ref, rtol=0, atol=0)
    jy = JaxEnginePlan(backend="sharded", bits=8, inner_backend=inner
                       ).apply(jax_pack_linear(jnp.asarray(w), 8),
                               jnp.asarray(x), out_dtype=jnp.float32)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jy))


@pytest.fixture(scope="module")
def model():
    cfg = reduced_f32("qwen2.5-3b")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    return cfg, params, tcfg, tparams


def test_what_a_mesh_refuses(model, monkeypatch):
    """Graphs on an NCCL mesh raise, naming ROADMAP queue 1 item 8 (e)
    (on ``gloo`` they are segmented at the collectives; the 8-rank test's
    ``(2, 4)`` engine takes ``cuda_graphs=True`` and serves JAX's tokens,
    eagerly on the CPU), as do packed weights without the sharded
    backend; chaos injection builds.  Slots mode and the moe family build and step: on a one-rank
    mesh (no collective runs) they give one device's tokens, and a paged
    engine's snapshot there is one device's, which restores into a fresh
    one-rank engine."""
    from repro_torch.dist.hints import Mesh
    from repro_torch.ft import ChaosInjector
    from repro_torch.models import init_params

    _, _, tcfg, tparams = model
    mesh = StandIn((4, 2), ("data", "model"))

    def build(cfg=tcfg, params=tparams, mesh=mesh, **kw):
        kw.setdefault("cuda_graphs", False)
        return ServeEngine(cfg, params, tconfig.ServeConfig(
            max_new_tokens=3, engine=kw.pop("engine",
                                            tconfig.EngineConfig())),
            device="cpu", mesh=mesh, **kw)

    from repro_torch.dist import collectives

    with monkeypatch.context() as nccl:
        nccl.setattr(collectives, "backend", lambda: "nccl")
        with pytest.raises(ValueError, match=r"item 8 \(e\)"):
            build(cuda_graphs=True)
    with pytest.raises(ValueError, match="sharded backend"):
        build(engine=tconfig.EngineConfig(weight_bits=8,
                                          backend="reference"))

    one = Mesh((1, 1), ("data", "model"), 0, torch.device("cpu"),
                {("data",): None, ("model",): None})
    assert build(mesh=one, chaos=ChaosInjector(seed=0)).chaos is not None
    moe_cfg = dataclasses.replace(tconfig.get_reduced("qwen3-moe-235b-a22b"),
                                  dtype="float32")
    moe_params = init_params(moe_cfg, torch.Generator().manual_seed(0))
    for cfg, params, mode in ((tcfg, tparams, "slots"),
                              (moe_cfg, moe_params, "paged"),
                              (moe_cfg, moe_params, "slots")):
        tokens = []
        for m in (None, one):
            eng = build(cfg, params, m, mode=mode)
            for p in PROMPTS:
                eng.submit(list(p))
            tokens.append([r.output for r in sorted(eng.run(),
                                                    key=lambda r: r.rid)])
        assert tokens[0] == tokens[1], (cfg.family, mode)
        assert eng.mesh_layout["data_shards"] == 1
        if mode == "paged":
            snap = eng.snapshot()
            assert snap["arrays"]["pages/k"].shape == eng.pages.k.shape
            fresh = build(cfg, params, one, mode=mode)
            fresh.restore(snap)
            fresh.audit()


def test_serving_placement_keeps_whole_heads(model):
    """Where the KV heads divide the model axis the serving placement is
    JAX's ``param_shardings``; where they do not (reduced qwen2.5-3b's 2
    KV heads over 4), JAX's name-only rule still splits wq/wk/wv's
    columns and wo's rows mid-head, and the port keeps the attention
    block whole on every rank (the MLP and the vocabulary still shard)."""
    cfg, _, tcfg, tparams = model
    for shape, heads_divide in (((4, 2), True), ((2, 4), False)):
        mesh = StandIn(shape, ("data", "model"))
        jspecs = param_shardings(mesh, tparams)
        sspecs = serve_param_specs(mesh, tparams, tcfg)
        for layer in range(tcfg.n_layers):
            attn_j, attn_s = (jspecs["layers"][layer]["attn"],
                              sspecs["layers"][layer]["attn"])
            for name in ("wq", "wk", "wv", "wo"):
                assert "model" in tuple(attn_j[name]["w"])
                if heads_divide:
                    assert attn_s[name] == attn_j[name]
                else:
                    assert all(e is None for e in attn_s[name]["w"])
            assert (sspecs["layers"][layer]["mlp"]
                    == jspecs["layers"][layer]["mlp"])
        assert sspecs["embed"] == jspecs["embed"] == ("model", None)


def test_sharded_allocator_keeps_lanes_in_their_shard():
    """Lanes over data: two shards of 2 lanes and 10 pages (page 0 and 10
    their null pages).  A lane's pages come from its shard's range, the
    capacity checks count that range only, preemption looks for a victim
    in the same shard, and a shard's block-table rows come out in local
    page ids."""
    from repro_torch.serve.pages import NULL_PAGE, ShardedPageAllocator
    from repro_torch.serve.prefix_cache import PrefixCache
    from repro_torch.serve.scheduler import PagedScheduler

    alloc = ShardedPageAllocator(n_pages=20, page_size=4, n_slots=4,
                                 max_len=32, shards=2)
    assert alloc.capacity == 9 and alloc.free_pages == 18
    for slot, n_tokens in ((0, 20), (1, 12), (2, 32), (3, 4)):
        assert alloc.ensure(slot, n_tokens)
    assert all(0 < p < 10 for s in (0, 1) for p in alloc._mapped[s])
    assert all(10 < p < 20 for s in (2, 3) for p in alloc._mapped[s])
    alloc.audit()
    # shard 0 holds 5 + 3 of its 9 pages, shard 1 all 9
    assert alloc.can_allocate(1, 0) and not alloc.can_allocate(2, 1)
    assert not alloc.ensure(3, 8) and len(alloc._mapped[3]) == 1
    assert alloc.shares_pool(0, 1) and not alloc.shares_pool(1, 2)
    rows = alloc.local_pages(alloc.block_tables[2:4], 1)
    assert rows.shape == (2, alloc.max_blocks)
    assert rows[0].tolist() == [p - 10 for p in alloc._mapped[2]]
    assert rows[1, 1:].tolist() == [NULL_PAGE] * (alloc.max_blocks - 1)

    sched = PagedScheduler(alloc, chunk=3)

    class Req:
        def __init__(self, seq):
            self.admit_seq = seq

    sched.slot_req[:] = [Req(0), Req(1), Req(3), Req(2)]
    assert sched._pick_victim(exclude=3) == 2   # slot 0 is older
    assert sched._pick_victim(exclude=0) == 1
    alloc.free_slot(2)
    alloc.audit()
    assert alloc.ensure(3, 32)
    with pytest.raises(NotImplementedError):
        PrefixCache(alloc)
    with pytest.raises(ValueError, match="cannot hold one"):
        ShardedPageAllocator(n_pages=12, page_size=4, n_slots=4,
                             max_len=32, shards=4)


# ---------------------------------------------------------------------------
# 8 gloo ranks
# ---------------------------------------------------------------------------

SWEEP = [(bits, radix, inner, kind)
         for bits in (2, 4, 8) for radix in (1, 2, 4) if bits % radix == 0
         for inner in ("reference", "bit_serial")
         for kind in ("col", "row")]
SHAPES = {"col": (128, 64), "row": (128, 20)}


def _x_forms(x):
    """1-D, 2-D and batched 3-D activations."""
    return {"1d": x[0], "2d": x, "3d": np.stack([x, 2.0 * x])}


def _jax_serve(cfg, params, *, engine=None, n_slots=4, n_pages=None,
               max_new=6, prompts=PROMPTS, prefix_cache=False):
    eng = JaxServeEngine(cfg, params, JaxServeConfig(
        max_new_tokens=max_new, engine=engine or JaxEngineConfig()),
        n_slots=n_slots, max_len=32, mode="paged", page_size=4,
        n_pages=n_pages, prefill_chunk=3, attn_backend="gather",
        prefix_cache=prefix_cache)
    for p in prompts:
        eng.submit(list(p))
    return [r.output for r in sorted(eng.run(), key=lambda r: r.rid)]


SERVE_CASES = {
    "kv0": dict(),
    "kv8": dict(kv_bits=8),
    "preempt": dict(n_pages=12, max_new=16),
    "prefix": dict(n_slots=1, prefix_cache=True, prompts=PREFIX_PROMPTS),
    "lanes_over_data": dict(n_slots=8, n_pages=40, max_new=16,
                            prompts=SHARD_PROMPTS),
    "w8": dict(weight_bits=8),
}

RANK_CODE = """
import json
from repro_torch.config import EngineConfig, ServeConfig
from repro_torch.dist import gather_shards, local_shard
from repro_torch.dist.collectives import all_gather
from repro_torch.dist.sharding import param_shardings
from repro_torch.engine import EnginePlan, pack_linear, partition_kind
from repro_torch.serve import ServeEngine

case = torch.load(os.path.join(OUT, "case.pt"), weights_only=False)
out = {"sweep": {}, "serve": {}}

# -- the backend sweep on an 8-way model axis
mesh = make_mesh((1, 8), ("data", "model"), device="cpu")
for (bits, radix, inner, kind), (w, xs) in case["sweep"].items():
    name = "wq" if kind == "col" else "wo"
    lin = pack_linear(torch.from_numpy(w), bits)
    assert partition_kind(lin, 8) == kind, (kind, bits)
    tree = {name: lin}
    local = local_shard(tree, param_shardings(mesh, tree), mesh)[name]
    assert local.shard == kind, (local.shard, kind)
    plan = EnginePlan(backend="sharded", bits=bits, radix=radix,
                      mesh=mesh, inner_backend=inner)
    for form, x in xs.items():
        x = torch.from_numpy(x)
        if kind == "row":
            k = local.in_features
            x = x[..., mesh.index("model") * k:(mesh.index("model") + 1) * k]
        y = plan.apply(local, x)
        if kind == "col":
            y = all_gather(y, mesh.group("model"), dim=-1)
        out["sweep"][(bits, radix, inner, kind, form)] = y
w, x = case["psum"]
tree = {"wo": pack_linear(torch.from_numpy(w), 8)}
local = local_shard(tree, param_shardings(mesh, tree), mesh)["wo"]
k = local.in_features
xl = torch.from_numpy(x)[:, mesh.index("model") * k:(mesh.index("model") + 1) * k]
for bits in (0, 8):
    out[f"psum{bits}"] = EnginePlan(
        backend="sharded", bits=8, mesh=mesh, inner_backend="reference",
        psum_bits=bits).apply(local, xl)

# -- paged serving
cfg, params = case["cfg"], case["params"]


def serve(mesh, kv_bits=0, weight_bits=0, n_slots=4, n_pages=None,
          max_new=6, prompts=None, prefix_cache=False, cuda_graphs=False):
    ecfg = EngineConfig(kv_bits=kv_bits, weight_bits=weight_bits,
                        backend="reference", sharded=bool(weight_bits))
    eng = ServeEngine(cfg, params, ServeConfig(max_new_tokens=max_new,
                                               engine=ecfg),
                      n_slots=n_slots, max_len=32, mode="paged",
                      page_size=4, n_pages=n_pages, prefill_chunk=3,
                      prefix_cache=prefix_cache, device="cpu",
                      cuda_graphs=cuda_graphs, mesh=mesh)
    for p in prompts or case["prompts"]:
        eng.submit(list(p))
    toks = [r.output for r in sorted(eng.run(), key=lambda r: r.rid)]
    return eng, toks


m42 = make_mesh((4, 2), ("data", "model"), device="cpu")
for name, kw in case["serve"].items():
    eng, toks = serve(m42, **kw)
    out["serve"][name] = dict(
        tokens=toks, preemptions=eng.preemptions, layout=eng.mesh_layout,
        pool=tuple(eng.pages.k.shape), backend=eng.plan and eng.plan.backend,
        prefix=eng.prefix_stats())
    if name == "kv0":
        out["snapshot_pool"] = tuple(eng.snapshot()["arrays"]["pages/k"].shape)
m24 = make_mesh((2, 4), ("data", "model"), device="cpu")
# a gloo mesh takes cuda_graphs=True (eager on the CPU)
eng, toks = serve(m24, cuda_graphs=True)
out["serve"]["mesh_2x4"] = dict(tokens=toks, layout=eng.mesh_layout,
                                pool=tuple(eng.pages.k.shape),
                                graphs=eng.cuda_graphs)
put(out)
"""


def test_sharded_backend_and_mesh_serving_on_8_ranks(model, tmp_path):
    cfg, params, tcfg, tparams = model
    sweep = {}
    for bits, radix, inner, kind in SWEEP:
        w, x = grid_data(3, *SHAPES[kind], bits, seed=17 * bits + radix)
        sweep[(bits, radix, inner, kind)] = (w, _x_forms(x))
    psum = grid_data(4, 128, 20, 8, seed=9)
    torch.save({"sweep": sweep, "psum": psum, "cfg": tcfg,
                "params": tparams, "prompts": PROMPTS,
                "serve": SERVE_CASES}, tmp_path / "case.pt")
    res = run_ranks(tmp_path, 8, RANK_CODE)

    # the sweep: every rank's gathered output, bit for bit
    n_cases = 0
    for (bits, radix, inner, kind), (w, xs) in sweep.items():
        lin = pack_linear(torch.from_numpy(w), bits)
        jlin = jax_pack_linear(jnp.asarray(w), bits)
        for form, x in xs.items():
            ref = EnginePlan(backend=inner, bits=bits, radix=radix).apply(
                lin, torch.from_numpy(x))
            jref = JaxEnginePlan(backend="reference", bits=bits).apply(
                jlin, jnp.asarray(x), out_dtype=jnp.float32)
            np.testing.assert_array_equal(ref.numpy(), np.asarray(jref))
            for r, out in enumerate(res):
                got = out["sweep"][(bits, radix, inner, kind, form)]
                assert got.shape == ref.shape
                np.testing.assert_array_equal(
                    got.numpy(), ref.numpy(),
                    err_msg=f"rank {r} {inner}/{kind} bits={bits} "
                            f"radix={radix} {form}")
            n_cases += 1
    assert n_cases == 96, n_cases   # 8 (bits, radix) x 2 inner x 2 x 3

    # the compressed row-parallel sum: within n * scale / 2 of the exact
    w, x = psum
    wq = pack_linear(torch.from_numpy(w), 8).dequantize().double().numpy()
    parts = [x[:, i * 16:(i + 1) * 16] @ wq[i * 16:(i + 1) * 16]
             for i in range(8)]
    bound = 8.0 * (max(np.abs(p).max() for p in parts) / 127.0) / 2.0
    for out in res:
        np.testing.assert_array_equal(out["psum0"].numpy(),
                                      res[0]["psum0"].numpy())
        err = float((out["psum8"] - out["psum0"]).abs().max())
        assert 0 < err <= bound * 1.0001, (err, bound)

    # paged serving: every rank returns the same tokens, equal to the
    # unsharded port engine's and to JAX's unsharded gather engine's
    def port_serve(kv_bits=0, weight_bits=0, n_slots=4, n_pages=None,
                   max_new=6, prompts=PROMPTS, prefix_cache=False):
        eng = ServeEngine(tcfg, tparams, tconfig.ServeConfig(
            max_new_tokens=max_new, engine=tconfig.EngineConfig(
                kv_bits=kv_bits, weight_bits=weight_bits,
                backend="reference")),
            n_slots=n_slots, max_len=32, mode="paged", page_size=4,
            n_pages=n_pages, prefill_chunk=3, prefix_cache=prefix_cache,
            device="cpu")
        for p in prompts:
            eng.submit(list(p))
        return eng, [r.output for r in sorted(eng.run(),
                                              key=lambda r: r.rid)]

    served = [out["serve"] for out in res]
    for name, kw in list(SERVE_CASES.items()) + [("mesh_2x4", {})]:
        plain_eng, plain = port_serve(**kw)
        jkw = dict(kw)
        engine = JaxEngineConfig(kv_bits=jkw.pop("kv_bits", 0),
                                 weight_bits=jkw.pop("weight_bits", 0),
                                 backend="reference")
        assert _jax_serve(cfg, params, engine=engine, **jkw) == plain, name
        for r in range(8):
            assert served[r][name]["tokens"] == plain, (name, r)
        if name == "prefix":
            assert served[0][name]["prefix"] == plain_eng.prefix_stats()
            assert plain_eng.prefix_stats()["hits"] >= 2
    s = served[0]
    # the pool holds this rank's KV head (2 over model 2) and, with lanes
    # over data, its shard's quarter of the pages
    assert s["kv0"]["layout"]["data_shards"] == 4
    assert s["kv0"]["pool"][1:4] == (9, 4, 1)   # 33 pages padded to 36
    assert s["lanes_over_data"]["layout"]["data_shards"] == 4
    assert s["lanes_over_data"]["pool"][1] == 10
    assert s["lanes_over_data"]["preemptions"] > 0
    # 12 pages cannot give each of 4 shards a max_len request: whole
    assert s["preempt"]["layout"]["whole_over_data"]
    assert s["preempt"]["preemptions"] > 0
    assert s["prefix"]["layout"]["whole_over_data"]
    assert s["w8"]["backend"] == "sharded"
    # (2, 4): the 2 KV heads stay whole on every rank; built with
    # cuda_graphs=True on gloo, it served JAX's tokens eagerly on the CPU
    assert s["mesh_2x4"]["layout"]["kv_heads"] == 2
    assert s["mesh_2x4"]["graphs"] is False
    # a snapshot gathers the pool to one device's shape on every rank
    assert all(out["snapshot_pool"][1:4] == (36, 4, 2) for out in res)
