"""PyTorch port vs JAX: every family on a ``(data, model)`` mesh of ranks.

In one process, on every config's reduced tree (whole and engine-packed)
over stand-in meshes ``(1, 8)``, ``(2, 4)`` and ``(4, 2)``:
``serve_param_specs`` by block kind (stacked experts over ``model`` where
E divides, the router whole; SSM blocks whole; the hybrid's
``shared_attn`` whole-head; the audio embedding's rows over V; elsewhere
JAX's ``param_shardings``), ``rank_view`` on each rank's shards (its
heads, groups, vocabulary rows and experts), and ``rank_shapes`` (the
kernels' shapes read without weights) against a rank's real shards.

On 8 ``gloo`` ranks (one spawned group, ``test_torch_dist.run_ranks``):

* ``decode_step(mesh=)`` against JAX's single-device ``decode_step``
  within rtol = atol = 2e-4 (the bound of JAX's own
  ``tests/test_dist.py`` ``test_serve_step_sharded_decode``): reduced
  gemma3-27b at ``(2, 4)`` over 12 steps (past its window of 8), reduced
  zamba2-7b and mamba2-130m at ``(4, 2)``; and gemma3 at ``(4, 2)`` in
  the other three slots-cache layouts (split local/global, unstacked,
  int8) against the port's single-device step, int8 at the int8 cache's
  tolerance (``test_torch_serve.DENSE_KV8_TOL``);
* served greedy tokens equal to JAX's single-device engine's (its
  ``gather`` backend; ``ROADMAP.md`` queue 3's caveat) on ``(4, 2)`` and
  ``(2, 4)``: paged reduced llava-next, musicgen, llama4-scout and
  qwen3-moe, slots mode for all six families; qwen3-moe also at
  ``weight_bits=8`` through the ``sharded`` backend's grouped form; the
  ranks' ``experts_touched``, summed, equal to one device's;
* the expert-parallel ``moe_block`` against one device: bit for bit on
  an integer grid (float and 8-bit packed experts, ``psum_bits=0``),
  within 1e-5 on seeded float32 data (with llama4-scout's row-parallel
  shared expert); qwen3-moe at ``(1, 8)`` (one expert a rank) and
  llama4-scout at ``(2, 4)``.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import EngineConfig as JaxEngineConfig
from repro.config.base import ServeConfig as JaxServeConfig
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.serve import ServeEngine as JaxServeEngine

import repro_torch.config as tconfig
from repro_torch.config import get_reduced
from repro_torch.dist.hints import Mesh
from repro_torch.engine import EnginePlan, PackedLinear, pack_linear
from repro_torch.dist.sharding import (
    local_shard,
    param_shardings,
    rank_shapes,
    serve_param_specs,
    tree_map_with_path,
)
from repro_torch.models import decode_step, init_cache, init_params
from repro_torch.models import quantize_params
from repro_torch.models.moe import moe_block
from repro_torch.models.transformer import rank_view
from repro_torch.serve import ServeEngine
from repro_torch.weights import params_from_numpy

from conftest import ALL_ARCHS, reduced_f32
from test_torch_dist import run_ranks
from test_torch_model import jax_params_to_numpy, torch_cfg
from test_torch_serve import DENSE_KV8_TOL

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
MESHES = {"1x8": (1, 8), "2x4": (2, 4), "4x2": (4, 2)}
SERVE_MESHES = ("4x2", "2x4")
# qwen3-moe's 8 experts over 8 ranks with whole lanes: every rank counts
# its own expert, and the ranks' touched counts sum to one device's
TOUCHED = ("1x8", "paged_qwen3-moe-235b-a22b")
PROMPTS = [[1, 2, 3], [4], [5, 6, 7, 8, 9], [7, 8, 9, 10]]
MAX_NEW = 4
PAGED = ["llava-next-mistral-7b", "musicgen-medium", "llama4-scout-17b-a16e",
         "qwen3-moe-235b-a22b"]
SLOTS = ["qwen2.5-3b", "llava-next-mistral-7b", "musicgen-medium",
         "qwen3-moe-235b-a22b", "mamba2-130m", "zamba2-7b"]
# (name, arch, mode, weight_bits)
SERVE_CASES = ([(f"paged_{a}", a, "paged", 0) for a in PAGED]
               + [(f"slots_{a}", a, "slots", 0) for a in SLOTS]
               + [("paged_qwen3-moe_w8", "qwen3-moe-235b-a22b", "paged", 8)])
# decode_step against JAX: (name, arch, mesh, lanes, steps)
DECODE_CASES = [("gemma3", "gemma3-27b", "2x4", 2, 12),
                ("zamba2", "zamba2-7b", "4x2", 4, 6),
                ("mamba2", "mamba2-130m", "4x2", 4, 6)]
# gemma3's other layouts at (4, 2), against the port's single device
LAYOUTS = {"split": dict(split_local=True), "unstacked": dict(stacked=False),
           "int8": dict(kv_bits=8)}
LAYOUT_LANES, LAYOUT_STEPS = 4, 12


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = reduced_f32(arch)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    return cfg, params, tcfg, params_from_numpy(jax_params_to_numpy(params),
                                                tcfg, device="cpu")


def _tokens(cfg, lanes, steps, seed=5):
    shape = (lanes, steps) + ((cfg.n_codebooks,) if cfg.family == "audio"
                              else ())
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# one process: the placement and a rank's view of it
# ---------------------------------------------------------------------------


class StandIn(Mesh):
    """Rank ``rank`` of a mesh as the placement sees it: coordinates and
    counts, with a named sentinel for each group (no collective runs)."""

    def __init__(self, shape, rank=0):
        super().__init__(shape, ("data", "model"), rank,
                         torch.device("cpu"),
                         {("data",): "data-group", ("model",): "model-group"})


def _port_tree(arch, packed):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, (quantize_params(params, cfg, 4) if packed else params)


def _main(spec):
    """The spec of a linear's weight (its codes when packed)."""
    if hasattr(spec, "packed"):
        return tuple(spec.packed)
    return tuple(spec["w"] if isinstance(spec, dict) else spec)


def _flat(spec_tree, prefix=()):
    out = {}
    if isinstance(spec_tree, dict):
        for k, v in spec_tree.items():
            out.update(_flat(v, prefix + (k,)))
    elif isinstance(spec_tree, list):
        for i, v in enumerate(spec_tree):
            out.update(_flat(v, prefix + (i,)))
    elif dataclasses.is_dataclass(spec_tree):
        for f in dataclasses.fields(spec_tree):
            v = getattr(spec_tree, f.name)
            if isinstance(v, tuple):
                out[prefix + (f.name,)] = tuple(v)
    else:
        out[prefix] = tuple(spec_tree)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serve_param_specs_by_block(arch, packed, mesh):
    cfg, params = _port_tree(arch, packed)
    m = StandIn(MESHES[mesh])
    msize = MESHES[mesh][1]
    jax_specs = param_shardings(m, params)
    specs = serve_param_specs(m, params, cfg)
    heads_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % msize == 0
    changed = set()

    def whole(tree, path):
        flat = _flat(tree)
        assert all(all(e is None for e in s) for s in flat.values()), path
        changed.update(path + k for k in flat)

    for i, layer in enumerate(specs["layers"]):
        if "attn" in layer:
            if heads_ok:
                assert all("model" in _main(layer["attn"][k])
                           for k in ("wq", "wk", "wv", "wo"))
            else:
                whole(layer["attn"], ("layers", i, "attn"))
        if "moe" in layer:
            moe = layer["moe"]
            assert all(e is None for e in _flat(moe["router"]).get(
                ("w",), ())), "router sharded"
            ok = cfg.n_experts % msize == 0
            for k in ("w_gate", "w_up", "w_down"):
                spec = _main(moe[k])
                assert spec[0] == ("model" if ok else None), (k, spec)
                assert all(e is None for e in spec[1:]), (k, spec)
                if packed:
                    assert tuple(moe[k].scale)[0] == spec[0]
            changed.update(("layers", i, "moe") + k
                           for k in _flat(moe) if k[0] != "shared")
        if "ssm" in layer:
            whole(layer["ssm"], ("layers", i, "ssm"))
    if "shared_attn" in specs:
        attn = specs["shared_attn"]["attn"]
        if heads_ok:
            assert all("model" in _main(attn[k])
                       for k in ("wq", "wk", "wv", "wo"))
        else:
            whole(attn, ("shared_attn", "attn"))
    embed = tuple(specs["embed"])
    assert embed[-2] == ("model" if cfg.vocab_size % msize == 0 else None)
    assert all(e is None for j, e in enumerate(embed)
               if j != len(embed) - 2)
    # everything else is JAX's name-only rule
    ours, theirs = _flat(specs), _flat(jax_specs)
    assert ours.keys() == theirs.keys()
    for path, spec in ours.items():
        if path not in changed:
            assert spec == theirs[path], path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rank_view_on_every_rank(arch, mesh):
    """Each rank's shards, read back by ``rank_view``: its heads, groups,
    vocabulary rows and experts, for every family; one rank's lookups,
    summed over the model axis, give the whole table's."""
    cfg, params = _port_tree(arch, True)
    shape = MESHES[mesh]
    msize = shape[1]
    specs = serve_param_specs(StandIn(shape), params, cfg)
    heads_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % msize == 0
    tokens = torch.arange(cfg.vocab_size)
    if cfg.family == "audio":
        tokens = torch.stack([tokens.roll(7 * k)
                              for k in range(cfg.n_codebooks)], -1)
    looked = 0
    for rank in range(msize):      # data index 0, every model index
        m = StandIn(shape, rank)
        local = local_shard(params, specs, m)
        view = rank_view(local, cfg, m)
        assert (view.hq, view.hkv) == (
            (cfg.n_heads // msize, cfg.n_kv_heads // msize) if heads_ok
            else (cfg.n_heads, cfg.n_kv_heads))
        assert view.attn_group == ("model-group" if heads_ok else None)
        vocab_cut = cfg.vocab_size % msize == 0
        assert view.vocab_group == ("model-group" if vocab_cut else None)
        assert view.vocab_lo == (rank * cfg.vocab_size // msize
                                 if vocab_cut else 0)
        if cfg.family == "moe" and cfg.n_experts % msize == 0:
            e_local = cfg.n_experts // msize
            assert (view.n_experts, view.expert_lo) == (e_local,
                                                        rank * e_local)
            assert local["layers"][0]["moe"]["w_gate"].shard == "expert"
            assert local["layers"][0]["moe"]["router"]["w"].shape == \
                params["layers"][0]["moe"]["router"]["w"].shape
        else:
            assert view.expert_group is None and view.n_experts is None
        if cfg.family in ("ssm", "hybrid"):
            assert local["layers"][0]["ssm"]["in_proj"].shard is None
        if view.vocab_group is not None:
            table = local["embed"]
            rows = table.shape[-2]
            ids = tokens - view.vocab_lo
            held = (ids >= 0) & (ids < rows)
            if cfg.family == "audio":
                got = sum(torch.where(held[:, k, None],
                                      table[k][ids[:, k].clamp(0, rows - 1)],
                                      0.0) for k in range(cfg.n_codebooks))
            else:
                got = torch.where(held[:, None],
                                  table[ids.clamp(0, rows - 1)], 0.0)
            looked = looked + got
    if not isinstance(looked, int):
        emb = params["embed"]
        want = (sum(emb[k][tokens[:, k]] for k in range(cfg.n_codebooks))
                if cfg.family == "audio" else emb[tokens])
        torch.testing.assert_close(looked, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_local_shard_copies_every_block(arch):
    """A rank's blocks hold their own bytes only: a block cut along its
    leading axis (vocabulary rows, a row-parallel linear's packed rows,
    stacked experts) kept as a view would hold the whole leaf's storage
    after the whole tree is dropped."""
    cfg, params = _port_tree(arch, True)
    m = StandIn((1, 2), 1)
    local = local_shard(params, serve_param_specs(m, params, cfg), m)
    leaves = []
    tree_map_with_path(lambda path, leaf: leaves.append((path, leaf)),
                       local)
    for path, leaf in leaves:
        assert leaf.untyped_storage().nbytes() == \
            leaf.numel() * leaf.element_size(), path
    assert local["embed"].shape[-2] == cfg.vocab_size // 2


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rank_shapes_match_the_shards(arch, mesh):
    """``rank_shapes`` (shapes only, one layer under ``FakeTensorMode``)
    gives the linears, stacked experts and attention heads of the last
    rank's real shards of the packed tree."""
    cfg, params = _port_tree(arch, True)
    shape = MESHES[mesh]
    m = StandIn(shape, math.prod(shape) - 1)
    local = local_shard(params, serve_param_specs(m, params, cfg), m)
    linears, experts = {}, {}
    for lin in _packed_linears(local):
        k, n = lin.in_features, lin.out_features
        if lin.packed.ndim == 2:
            linears[k, n] = None
        else:
            experts[k, n, lin.packed.shape[0]] = None
    got = rank_shapes(cfg, shape, rank=m.rank)
    assert sorted(got.linears) == sorted(linears)
    assert sorted(got.experts) == sorted(experts)
    view = rank_view(local, cfg, m)
    has_attn = cfg.family not in ("ssm",)
    assert got.heads == ((view.hkv, view.hq // view.hkv,
                          cfg.resolved_head_dim) if has_attn else None)


def _packed_linears(tree):
    if isinstance(tree, PackedLinear):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _packed_linears(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _packed_linears(v)


# ---------------------------------------------------------------------------
# 8 gloo ranks
# ---------------------------------------------------------------------------


def _jax_decode(arch, lanes, steps):
    cfg, params, _, _ = _model(arch)
    toks = _tokens(cfg, lanes, steps)
    cache = jax_init_cache(cfg, lanes, max_len=16)
    step = jax.jit(functools.partial(jax_decode_step, cfg=cfg))
    out = []
    for t in range(steps):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]))
        out.append(np.asarray(lg))
    return toks, out


def _port_decode(arch, lanes, steps, **layout):
    _, _, tcfg, tparams = _model(arch)
    toks = _tokens(tcfg, lanes, steps)
    cache = init_cache(tcfg, lanes, 16, device="cpu", **layout)
    return [decode_step(tparams, cache, torch.from_numpy(toks[:, t:t + 1]),
                        tcfg)[0] for t in range(steps)]


def _jax_serve(arch, mode, weight_bits):
    cfg, params, _, _ = _model(arch)
    kw = dict(page_size=4, prefill_chunk=3) if mode == "paged" else {}
    eng = JaxServeEngine(cfg, params, JaxServeConfig(
        max_new_tokens=MAX_NEW, engine=JaxEngineConfig(
            weight_bits=weight_bits, backend="reference")),
        n_slots=4, max_len=32, mode=mode, attn_backend="gather", **kw)
    for p in PROMPTS:
        eng.submit(list(p))
    return [r.output for r in sorted(eng.run(), key=lambda r: r.rid)]


def _port_serve(arch, mode, weight_bits):
    """The port's single-device engine: its tokens and, for moe, the
    experts its steps touched."""
    _, _, tcfg, tparams = _model(arch)
    eng = ServeEngine(tcfg, tparams, tconfig.ServeConfig(
        max_new_tokens=MAX_NEW, engine=tconfig.EngineConfig(
            weight_bits=weight_bits, backend="reference")),
        n_slots=4, max_len=32, mode=mode, page_size=4, prefill_chunk=3,
        device="cpu")
    for p in PROMPTS:
        eng.submit(list(p))
    toks = [r.output for r in sorted(eng.run(), key=lambda r: r.rid)]
    return toks, eng.experts_touched


def _moe_inputs(arch, grid, seed):
    """(cfg, float params, 8-bit packed params, x) of one MoE layer: on an
    integer grid (weights k/8 with each column's absmax 7/8, so 8-bit
    packing is exact; x small integers; no shared expert), or seeded
    normal data (with llama4-scout's shared expert)."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def w(*shape):
        if not grid:
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32) / np.sqrt(shape[-2]))
        q = rng.integers(-7, 8, shape).astype(np.float32)
        q[..., 0, :] = 7.0
        return torch.from_numpy(q / 8.0)

    p = {"router": {"w": torch.from_numpy(rng.standard_normal(
             (d, e)).astype(np.float32))},
         "w_gate": w(e, d, f), "w_up": w(e, d, f), "w_down": w(e, f, d)}
    if cfg.n_shared_experts and not grid:
        # (the shared expert's row-parallel w_down sums its float32
        # partials in another order, so it is held to 1e-5 only)
        p["shared"] = {"w_gate": {"w": w(d, cfg.d_ff)},
                       "w_up": {"w": w(d, cfg.d_ff)},
                       "w_down": {"w": w(cfg.d_ff, d)}}
    x = (rng.integers(-2, 3, (3, 5, d)).astype(np.float32) if grid
         else rng.standard_normal((3, 5, d)).astype(np.float32))
    packed = dict(p, **{k: pack_linear(p[k], 8)
                        for k in ("w_gate", "w_up", "w_down")})
    return cfg, p, packed, torch.from_numpy(x)


MOE_CASES = [("qwen3", "qwen3-moe-235b-a22b", "1x8"),
             ("llama4", "llama4-scout-17b-a16e", "2x4")]

RANK_CODE = """
from repro_torch.config import EngineConfig, ServeConfig
from repro_torch.dist.collectives import all_gather
from repro_torch.dist.sharding import (cache_shardings, local_shard,
                                       serve_param_specs)
from repro_torch.engine import EnginePlan
from repro_torch.engine.sharded import lane_partition
from repro_torch.models import decode_step, init_cache
from repro_torch.models.moe import moe_block
from repro_torch.models.transformer import rank_view
from repro_torch.serve import ServeEngine

case = torch.load(os.path.join(OUT, "case.pt"), weights_only=False)
meshes = {label: make_mesh(shape, ("data", "model"), device="cpu")
          for label, shape in case["meshes"].items()}
out = {"decode": {}, "serve": {}, "moe": {}}


def mesh_decode(mesh, cfg, params, toks, **layout):
    specs = serve_param_specs(mesh, params, cfg)
    local = local_shard(params, specs, mesh)
    view = rank_view(local, cfg, mesh)
    lanes = toks.shape[0]
    _, shards = lane_partition(mesh, "model", cfg.n_kv_heads, lanes)
    n = lanes // shards
    lo = mesh.index(mesh.data_axes()) * n if shards > 1 else 0
    cache = init_cache(cfg, n, 16, device="cpu", n_kv_heads=view.hkv,
                       **layout)
    if not layout:   # the rank's cache is cache_shardings' block
        whole = init_cache(cfg, lanes, 16, device="cpu")
        placed = local_shard(whole, cache_shardings(mesh, whole), mesh)
        if shards == 1 or view.hkv != cfg.n_kv_heads:
            assert {k: tuple(v.shape) for k, v in placed.items()} == \\
                {k: tuple(v.shape) for k, v in cache.items()}
    logits = []
    for t in range(toks.shape[1]):
        lg, _ = decode_step(local, cache,
                            torch.from_numpy(toks[lo:lo + n, t:t + 1]), cfg,
                            mesh=mesh)
        if shards > 1:
            lg = all_gather(lg, mesh.group(mesh.data_axes()), dim=0)
        logits.append(lg)
    return logits


for name, (arch, label, layout) in case["decode"].items():
    cfg, params = case["models"][arch]
    out["decode"][name] = mesh_decode(meshes[label], cfg, params,
                                      case["decode_tokens"][name], **layout)

for label, name, arch, mode, bits in case["serve"]:
    mesh = meshes[label]
    cfg, params = case["models"][arch]
    eng = ServeEngine(cfg, params, ServeConfig(
        max_new_tokens=case["max_new"], engine=EngineConfig(
            weight_bits=bits, backend="reference", sharded=bool(bits))),
        n_slots=4, max_len=32, mode=mode, page_size=4, prefill_chunk=3,
        device="cpu", cuda_graphs=False, mesh=mesh)
    for p in case["prompts"]:
        eng.submit(list(p))
    toks = [r.output for r in sorted(eng.run(), key=lambda r: r.rid)]
    store = eng.pages.k if mode == "paged" else eng.cache.get(
        "k", eng.cache.get("conv"))
    out["serve"][label, name] = dict(
        tokens=toks, layout=eng.mesh_layout,
        cache=tuple(store.shape), touched=eng.experts_touched,
        backend=eng.plan and eng.plan.backend,
        lanes=eng.lanes.tokens.shape[0])

for name, (label, cfg, p, packed, x) in case["moe"].items():
    mesh = meshes[label]
    for kind, tree in (("float", p), ("w8", packed)):
        local = local_shard(tree, serve_param_specs(
            mesh, {"layers": [{"moe": tree}]}, cfg)["layers"][0]["moe"],
            mesh)
        view = rank_view({"layers": [{"moe": local}],
                          "embed": torch.zeros(cfg.vocab_size, 1),
                          "lm_head": {"w": torch.zeros(1, cfg.vocab_size)}},
                         cfg, mesh)
        plan = EnginePlan(backend="sharded", bits=8, mesh=mesh,
                          inner_backend="reference") if kind == "w8" \\
            else None
        counts = torch.zeros(cfg.n_experts, dtype=torch.int32)
        y, aux = moe_block(local, x, cfg, plan, counts, view)
        out["moe"][name, kind] = dict(y=y, aux=aux, counts=counts,
                                      n_experts=view.n_experts,
                                      expert_lo=view.expert_lo)
put(out)
"""


def test_every_family_on_8_ranks(tmp_path):
    archs = sorted({a for _, a, _, _ in SERVE_CASES}
                   | {a for _, a, _, _, _ in DECODE_CASES})
    models = {a: (_model(a)[2], _model(a)[3]) for a in archs}
    decode = {name: (arch, label, {})
              for name, arch, label, _, _ in DECODE_CASES}
    decode_tokens = {name: _tokens(_model(arch)[2], lanes, steps)
                     for name, arch, _, lanes, steps in DECODE_CASES}
    for lname, layout in LAYOUTS.items():
        decode[f"gemma3_{lname}"] = ("gemma3-27b", "4x2", layout)
        decode_tokens[f"gemma3_{lname}"] = _tokens(
            _model("gemma3-27b")[2], LAYOUT_LANES, LAYOUT_STEPS)
    serve_runs = [(label,) + c for label in SERVE_MESHES
                  for c in SERVE_CASES]
    serve_runs += [(TOUCHED[0],) + c for c in SERVE_CASES
                   if c[0] == TOUCHED[1]]
    moe = {}
    for name, arch, label in MOE_CASES:
        for grid in (True, False):
            cfg, p, packed, x = _moe_inputs(arch, grid, seed=len(name))
            moe[f"{name}_{'grid' if grid else 'seeded'}"] = (
                label, cfg, p, packed, x)
    torch.save({"meshes": MESHES, "models": models, "decode": decode,
                "decode_tokens": decode_tokens, "serve": serve_runs,
                "prompts": PROMPTS, "max_new": MAX_NEW,
                "moe": moe}, tmp_path / "case.pt")
    res = run_ranks(tmp_path, 8, RANK_CODE, timeout=420)

    # decode_step(mesh=) against JAX's single-device step
    for name, arch, label, lanes, steps in DECODE_CASES:
        toks, want = _jax_decode(arch, lanes, steps)
        np.testing.assert_array_equal(toks, decode_tokens[name])
        for r, out in enumerate(res):
            got = out["decode"][name]
            assert len(got) == steps
            for t in range(steps):
                np.testing.assert_allclose(
                    got[t].numpy(), want[t], **TOL,
                    err_msg=f"{name} rank {r} step {t}")
    # the other layouts against the port's single device
    for lname, layout in LAYOUTS.items():
        want = _port_decode("gemma3-27b", LAYOUT_LANES, LAYOUT_STEPS,
                            **layout)
        tol = DENSE_KV8_TOL if lname == "int8" else TOL
        for r, out in enumerate(res):
            for t, lg in enumerate(out["decode"][f"gemma3_{lname}"]):
                torch.testing.assert_close(lg, want[t], **tol,
                                           msg=f"{lname} rank {r} step {t}")

    # served tokens: every rank's equal to JAX's single-device engine's
    for name, arch, mode, bits in SERVE_CASES:
        want = _jax_serve(arch, mode, bits)
        port, touched = _port_serve(arch, mode, bits)
        assert port == want, name
        labels = SERVE_MESHES + ((TOUCHED[0],) if name == TOUCHED[1]
                                 else ())
        for label in labels:
            for r, out in enumerate(res):
                assert out["serve"][label, name]["tokens"] == want, (
                    label, name, r)
        if name == TOUCHED[1]:
            # each rank counts its own expert; summed, one device's
            for kind in ("decode", "prefill"):
                summed = np.sum([out["serve"][TOUCHED][
                    "touched"][kind] for out in res], axis=0)
                assert summed.tolist() == touched[kind], kind
                assert max(out["serve"][TOUCHED]["touched"][kind][0]
                           for out in res) <= 3     # one expert, 3 layers
    s = {key: rec for key, rec in res[0]["serve"].items()}
    # lanes over data where 4 lanes divide it; KV heads over model where
    # they divide it (llava: 2 KV heads, musicgen and zamba2: 4)
    assert s["4x2", "paged_llava-next-mistral-7b"]["cache"][3] == 1
    assert s["2x4", "paged_llava-next-mistral-7b"]["cache"][3] == 2
    assert s["2x4", "paged_musicgen-medium"]["cache"][3] == 1
    assert s["4x2", "slots_zamba2-7b"]["lanes"] == 1
    assert s["2x4", "slots_qwen2.5-3b"]["cache"][1] == 2   # lanes
    assert s["2x4", "slots_qwen2.5-3b"]["cache"][3] == 2   # KV heads
    assert s["4x2", "slots_mamba2-130m"]["cache"][1] == 1
    assert s["4x2", "paged_qwen3-moe_w8"]["backend"] == "sharded"
    for label in SERVE_MESHES:
        for name, _, _, _ in SERVE_CASES:
            assert s[label, name]["layout"]["data_shards"] == \
                MESHES[label][0], (label, name)

    # the expert-parallel MoE block against one device
    for key, (label, cfg, p, packed, x) in moe.items():
        grid = key.endswith("grid")
        m = MESHES[label][1]
        for kind, tree in (("float", p), ("w8", packed)):
            plan = (EnginePlan(backend="reference", bits=8)
                    if kind == "w8" else None)
            counts = torch.zeros(cfg.n_experts, dtype=torch.int32)
            want, aux = moe_block(tree, x, cfg, plan, counts)
            summed = torch.zeros_like(counts)
            for r, out in enumerate(res):
                got = out["moe"][key, kind]
                assert got["n_experts"] == cfg.n_experts // m
                e_lo = (r % m) * (cfg.n_experts // m)
                assert got["expert_lo"] == e_lo
                if grid:
                    assert torch.equal(got["y"], want), (key, kind, r)
                else:
                    torch.testing.assert_close(got["y"], want, rtol=1e-5,
                                               atol=1e-5)
                assert torch.equal(got["aux"], aux)
                outside = torch.ones(cfg.n_experts, dtype=torch.bool)
                outside[e_lo:e_lo + cfg.n_experts // m] = False
                assert not got["counts"][outside].any()
                if r < m:
                    summed += got["counts"]
            assert torch.equal(summed, counts), (key, kind)
