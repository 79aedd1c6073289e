"""PyTorch port vs JAX: the distribution layer (``repro_torch.dist``).

* The spec functions (``param_spec``, ``param_shardings`` tp / fsdp,
  ``batch_shardings``, ``cache_shardings``, ``paged_attn_partition``,
  ``pool_pages_for_mesh``) against JAX's, on every config's reduced
  parameter tree (whole and engine-packed) and on ``KVPages`` pools, over
  stand-in meshes ``(1, 8)``, ``(2, 4)``, ``(4, 2)`` and ``(2, 2, 2)``
  with a pod axis.  Both packages see trees of one structure: JAX's
  functions run on the port's per-layer tree as shapes.
* ``partition_kind``, ``pack_linear(partition=)`` and ``quantize_params``'
  partition stamps against JAX.
* On 8 ``gloo`` ranks (one spawned group, rendezvous through a file under
  ``tmp_path``): the mesh's coordinates and groups, ``local_shard`` /
  ``gather_shards``, the exact ``psum_partial`` and ``compressed_psum_leaf``
  at 4 and 8 bits, held to ``|comp − plain| ≤ n·scale/2`` and lossless on
  an integer grid whose absmax is qmax.  Those two are held to their
  bound, not to JAX's outputs: JAX's own two tests of them fail on this
  host (``ROADMAP.md`` queue 3).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dist.sharding as jsharding
from repro.config import get_reduced as jax_reduced
from repro.engine import PackedLinear as JaxPackedLinear
from repro.engine import pack_linear as jax_pack_linear
from repro.engine import partition_kind as jax_partition_kind
from repro.models import init_params as jax_init_params
from repro.models.transformer import quantize_params as jax_quantize
from repro.serve.pages import init_kv_pages as jax_init_kv_pages

import repro_torch.dist.sharding as tsharding
from repro_torch.config import get_reduced
from repro_torch.engine import PackedLinear, pack_linear, partition_kind
from repro_torch.models import init_params, quantize_params
from repro_torch.serve.pages import init_kv_pages

from conftest import ALL_ARCHS

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


class StandIn:
    """A mesh as the spec functions see it: axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


MESHES = {"1x8": ((1, 8), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _specs_not_shardings(monkeypatch):
    """JAX's functions wrap each spec in a ``NamedSharding``, which needs a
    real mesh: hand the spec back instead, so stand-ins serve both."""
    monkeypatch.setattr(jsharding, "NamedSharding", lambda mesh, spec: spec)


def _jax_tree(tree):
    """The port's tree as JAX shapes of the same structure."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    if isinstance(tree, PackedLinear):
        return JaxPackedLinear(
            _jax_tree(tree.packed), _jax_tree(tree.scale),
            None if tree.bias is None else _jax_tree(tree.bias), tree.bits,
            tree.in_features, tree.out_features, tree.partition)
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _jax_specs(spec_tree):
    """{path as strings: spec as a tuple} of a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(jsharding._key_str(k) for k in path): tuple(spec)
            for path, spec in flat}


def _port_specs(spec_tree):
    out = {}
    tsharding.tree_map_with_path(
        lambda path, spec: out.setdefault(tuple(str(k) for k in path),
                                          tuple(spec)), spec_tree)
    return out


def _port_params(arch, packed):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return quantize_params(params, cfg, 4) if packed else params


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_jax(arch, packed, mesh):
    """tp and fsdp specs of every leaf, and ``param_spec`` leaf by leaf,
    equal JAX's on the same tree."""
    m = StandIn(*MESHES[mesh])
    params = _port_params(arch, packed)
    jtree = _jax_tree(params)
    for mode in ("tp", "fsdp"):
        ours = _port_specs(tsharding.param_shardings(m, params, mode=mode))
        theirs = _jax_specs(jsharding.param_shardings(m, jtree, mode=mode))
        assert ours == theirs, (arch, mode)
    assert ours, "no leaves compared"
    one = jax.tree_util.tree_map_with_path(
        lambda p, leaf: jsharding.param_spec(p, leaf, m), jtree)
    assert _port_specs(tsharding.param_shardings(m, params)) == \
        _jax_specs(one)
    assert _port_specs(tsharding.opt_state_shardings(m, params)) == \
        _jax_specs(jsharding.opt_state_shardings(m, jtree))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-27b",
                                  "llama4-scout-17b-a16e"])
def test_cache_and_batch_specs_match_jax(arch, kv_bits, mesh):
    """A ``KVPages`` pool (int8 with its scale pools), the page state and
    a batch: the port's specs equal JAX's."""
    m = StandIn(*MESHES[mesh])
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    for n_pages in (9, 16):
        pages = init_kv_pages(cfg, n_pages, 4, kv_bits=kv_bits,
                              device="cpu")
        jpages = jax.eval_shape(
            lambda: jax_init_kv_pages(jcfg, n_pages, 4, kv_bits=kv_bits))
        ours = tsharding.cache_shardings(m, pages)
        theirs = jsharding.cache_shardings(m, jpages)
        for name in ("k", "v", "k_scale", "v_scale"):
            if getattr(pages, name) is None:
                assert getattr(jpages, name) is None
                continue
            assert tuple(getattr(ours, name)) == \
                tuple(getattr(theirs, name)), (name, n_pages)
    for lanes in (3, 4, 8):
        state = {"block_tables": np.zeros((lanes, 8), np.int32),
                 "pos": np.zeros((lanes,), np.int32),
                 "active": np.zeros((lanes,), bool),
                 "tokens": np.zeros((lanes, 16), np.int32)}
        assert _port_specs(tsharding.cache_shardings(m, state)) == \
            _jax_specs(jsharding.cache_shardings(m, state))
        assert _port_specs(tsharding.batch_shardings(m, state)) == \
            _jax_specs(jsharding.batch_shardings(m, state))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_partitions_and_pool_pages_match_jax(mesh):
    m = StandIn(*MESHES[mesh])
    for hkv in (0, 1, 2, 3, 4, 8, 16):
        for batch in (0, 1, 2, 4, 6, 8, 16):
            for axis in ("model", "data"):
                assert (tsharding.paged_attn_partition(m, axis, hkv, batch)
                        == jsharding.paged_attn_partition(m, axis, hkv,
                                                          batch))
    for n in (0, 1, 7, 9, 12, 33, 513):
        assert (tsharding.pool_pages_for_mesh(n, m)
                == jsharding.pool_pages_for_mesh(n, m))
    assert tsharding.pool_pages_for_mesh(9, None) == 9


def test_filter_entry_and_hints_match_jax():
    from repro.dist.hints import _filter_entry as jax_filter
    from repro_torch.dist.hints import _filter_entry, with_hint

    axes = {"pod": 2, "data": 4, "model": 2}
    for entry in (None, "data", "nope", ("pod", "data"), ("data", "model"),
                  ("nope", "model")):
        for dim in (1, 2, 4, 6, 8, 16):
            assert _filter_entry(entry, dim, axes) == \
                jax_filter(entry, dim, axes)
    x = torch.ones(4, 3)
    assert with_hint(x, "data", "model") is x


# ---------------------------------------------------------------------------
# partitions of packed weights
# ---------------------------------------------------------------------------


def _both(w, bits, **kw):
    return (pack_linear(torch.from_numpy(w), bits, **kw),
            jax_pack_linear(jnp.asarray(w), bits, **kw))


def test_partition_kind_matches_jax():
    rng = np.random.default_rng(1)
    cases = [((128, 64), None), ((128, 20), None), ((100, 20), None),
             ((128, 64), "row"), ((128, 64), "col"), ((100, 64), "row"),
             ((128, 20), "col"), ((24, 16), "row")]
    for (k, n), part in cases:
        w = rng.standard_normal((k, n)).astype(np.float32)
        for bits in (2, 4, 8):
            if (k * bits) % 8:
                continue
            ours, theirs = _both(w, bits, partition=part)
            assert ours.partition == theirs.partition == part
            for msize in (1, 2, 4, 8):
                assert partition_kind(ours, msize) == \
                    jax_partition_kind(theirs, msize), (k, n, part, bits,
                                                        msize)
            np.testing.assert_array_equal(ours.dequantize().numpy(),
                                          np.asarray(theirs.dequantize()))
    stacked = rng.standard_normal((4, 64, 64)).astype(np.float32)
    ours, theirs = _both(stacked, 8)
    assert partition_kind(ours, 8) == jax_partition_kind(theirs, 8) == \
        "replicate"
    with pytest.raises(ValueError):
        pack_linear(torch.zeros(8, 8), 8, partition="diag")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_quantize_params_stamps_partitions_as_jax(arch):
    """Every packed linear carries JAX's partition preference for its
    name (``wo`` / ``w_down`` / ``out_proj`` row, the rest col, stacked
    experts none), in ``quantize_params`` and in ``init_params``'
    packing as it draws."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    jparams = jax_quantize(jax_init_params(jcfg, jax.random.PRNGKey(0)),
                           jcfg, 8)

    def stamps(tree, cls, drop_index):
        out = {}

        def walk(node, path):
            if isinstance(node, cls):
                out[path] = node.partition
            elif isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    walk(v, path if drop_index else path + (i,))
        walk(tree, ())
        return out

    theirs = stamps(jparams, JaxPackedLinear, True)
    assert theirs
    for params in (quantize_params(init_params(
            cfg, torch.Generator().manual_seed(0)), cfg, 8),
            init_params(cfg, torch.Generator().manual_seed(0),
                        engine_bits=8)):
        assert stamps(params, PackedLinear, True) == theirs


# ---------------------------------------------------------------------------
# 8 gloo ranks
# ---------------------------------------------------------------------------

RANK_PRELUDE = """
import os, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.dist import close_rank, init_rank, make_mesh
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
init_rank(RANK, WORLD, os.path.join(OUT, "store"), backend="gloo")


def put(obj):
    torch.save(obj, os.path.join(OUT, f"rank{{RANK}}.pt"))
    close_rank()
"""


def run_ranks(tmp_path, world, code, timeout=240):
    """Run ``code`` in ``world`` processes that form one ``gloo`` group
    (a file store under ``tmp_path``); each saves its result with
    ``put``.  Returns the results in rank order; a rank that fails or
    outlives ``timeout`` fails the test, and every process is stopped."""
    prog = tmp_path / "rank_prog.py"
    prog.write_text(RANK_PRELUDE.format(src=str(ROOT / "src"))
                    + textwrap.dedent(code))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(prog), str(r), str(world), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}:\n"
                              f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def test_mesh_shards_and_collectives_on_8_ranks(tmp_path):
    rng = np.random.default_rng(0)
    g = rng.standard_normal((8, 64)).astype(np.float32)
    gi = rng.integers(-7, 8, (8, 32)).astype(np.float32)
    gi[0, 0] = 7.0
    w = rng.standard_normal((64, 48)).astype(np.float32)
    np.savez(tmp_path / "data.npz", g=g, gi=gi, w=w)
    res = run_ranks(tmp_path, 8, """
    from repro_torch.dist import (compressed_psum_leaf, gather_shards,
                                  local_shard, psum_partial)
    from repro_torch.dist.collectives import all_gather
    from repro_torch.engine import pack_linear

    d = np.load(os.path.join(OUT, "data.npz"))
    out = {}
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    out["coord"] = mesh.coord
    out["index"] = {k: mesh.index(k) for k in ("model", ("pod", "data"))}
    out["model_peers"] = all_gather(torch.tensor([RANK]),
                                    mesh.group("model")).tolist()
    out["data_peers"] = all_gather(torch.tensor([RANK]),
                                   mesh.group(("pod", "data"))).tolist()
    world = make_mesh((8,), ("pod",), device="cpu")
    grp = world.group("pod")
    row = {k: torch.from_numpy(d[k][RANK]) for k in ("g", "gi")}
    out["plain"] = psum_partial(row["g"], grp)
    for bits in (4, 8):
        out[f"comp{bits}"] = compressed_psum_leaf(row["g"], grp, bits)
    out["grid_plain"] = psum_partial(row["gi"], grp)
    out["grid4"] = compressed_psum_leaf(row["gi"], grp, 4)
    # a tree cut to this rank's blocks and gathered back
    tree = {"embed": torch.from_numpy(d["w"]),
            "layers": [{"attn": {"wo": pack_linear(torch.from_numpy(d["w"]),
                                                   4, partition="row")},
                        "mlp": {"w_up": {"w": torch.from_numpy(d["w"])}}}]}
    from repro_torch.dist.sharding import param_shardings
    specs = param_shardings(mesh, tree, mode="fsdp")
    local = local_shard(tree, specs, mesh)
    out["local_shapes"] = {
        "embed": tuple(local["embed"].shape),
        "wo": (tuple(local["layers"][0]["attn"]["wo"].packed.shape),
               local["layers"][0]["attn"]["wo"].shard,
               local["layers"][0]["attn"]["wo"].in_features),
        "w_up": tuple(local["layers"][0]["mlp"]["w_up"]["w"].shape)}
    back = gather_shards(local, specs, mesh)
    out["roundtrip"] = (
        torch.equal(back["embed"], tree["embed"])
        and torch.equal(back["layers"][0]["attn"]["wo"].packed,
                        tree["layers"][0]["attn"]["wo"].packed)
        and back["layers"][0]["attn"]["wo"].shard is None
        and back["layers"][0]["attn"]["wo"].in_features == 64
        and torch.equal(back["layers"][0]["mlp"]["w_up"]["w"],
                        tree["layers"][0]["mlp"]["w_up"]["w"]))
    put(out)
    """)
    for r, out in enumerate(res):
        pod, rest = divmod(r, 4)
        data, model = divmod(rest, 2)
        assert out["coord"] == {"pod": pod, "data": data, "model": model}
        assert out["index"] == {"model": model, ("pod", "data"):
                                pod * 2 + data}
        assert out["model_peers"] == [r - model, r - model + 1]
        assert out["data_peers"] == [model + 2 * i for i in range(4)]
        # the exact sum, and the compressed ones within n * scale / 2
        plain = g.sum(axis=0)
        np.testing.assert_allclose(out["plain"].numpy(), plain, rtol=1e-6,
                                   atol=1e-6)
        absmax = float(np.abs(g).max())
        for bits in (4, 8):
            qmax = 2 ** (bits - 1) - 1
            bound = 8 * (absmax / qmax) / 2
            err = float(np.abs(out[f"comp{bits}"].numpy()
                               - out["plain"].numpy()).max())
            assert 0 < err <= bound * 1.0001, (bits, err, bound)
        # absmax 7 = qmax: scale 1, the 4-bit wire is lossless
        np.testing.assert_array_equal(out["grid4"].numpy(),
                                      out["grid_plain"].numpy())
        np.testing.assert_array_equal(out["grid_plain"].numpy(),
                                      gi.sum(axis=0))
        # fsdp over (pod, data) = 4 on top of tp over model = 2
        assert out["local_shapes"] == {
            "embed": (32, 12), "wo": ((16, 12), "row", 32),
            "w_up": (16, 24)}, out["local_shapes"]
        assert out["roundtrip"]
    # every rank of the world sum saw the same result
    for key in ("plain", "comp4", "comp8"):
        assert all(torch.equal(o[key], res[0][key]) for o in res)
