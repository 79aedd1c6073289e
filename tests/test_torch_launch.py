"""PyTorch port vs JAX: the launch cells and the dry run.

* **FSDP train-cell bytes**: at ``(16, 16)`` and ``(2, 16, 16)``, for all
  10 configs, a rank's params and AdamW state in ``train_cell`` hold as
  many bytes as a device's under JAX's ``param_shardings`` /
  ``opt_state_shardings(mode="fsdp")`` (per leaf: its bytes over the mesh
  sizes of its spec; the mesh a ``FakeMesh``, as ``tests/test_dist.py``
  builds one).
* **Serve-cell bytes**: a rank's params under ``serve_param_specs`` hold as
  many bytes as a device's under JAX's tensor-parallel ``param_spec`` on
  every leaf where the two specs agree; the leaves where they do not are
  listed (the serving placement keeps whole heads where ``n_kv_heads``
  does not divide the model axis, and whole SSM blocks).
* **synthetic_batch_specs** has JAX's keys, shapes and dtypes for all six
  families.
* **Dry run = real mesh**: the collectives a dry ``(1, 2)`` and ``(2, 1)``
  mesh tallies for one paged decode step and one chunk of reduced
  qwen2.5-3b equal those of the same cells on two real ``gloo`` CPU
  ranks, family by family, rank by rank.
* **The CLI**: ``run_cell`` of reduced qwen2.5-3b writes a record with
  JAX's fields (``count_s`` in place of ``lower_s`` / ``compile_s``, no
  XLA figures); ``long_500k`` on a full-attention config exits as JAX's
  does; the full-width ``decode_32k --paged --engine-bits 4 --kv-bits 8``
  dry run writes JAX's file name in under 20 s.

The FSDP train steps against JAX and against one device are cases of
``tests/test_torch_mesh_train.py`` (its 8-rank group).
"""

import dataclasses
import math
import time

import jax
import pytest
import torch

from repro.config import get_arch as j_get_arch
from repro.data.pipeline import synthetic_batch_specs as j_batch_specs
from repro.dist.sharding import _with_fsdp, param_spec
from repro.launch.steps import abstract_params as j_abstract_params
from repro.optim import make_optimizer as j_make_optimizer

from repro_torch.config import get_arch, get_reduced
from repro_torch.config import base as tbase
from repro_torch.data.pipeline import synthetic_batch_specs
from repro_torch.dist.hints import dry_mesh
from repro_torch.dist.sharding import serve_param_specs, tree_map_with_path
from repro_torch.launch import dryrun
from repro_torch.launch.steps import (
    build_cell,
    sharded_abstract_params,
    train_cell,
)
from repro_torch.roofline import counted_costs
from repro_torch.roofline.op_cost import _tensors

from conftest import ALL_ARCHS
from test_torch_dist import run_ranks

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
FAMILY_ARCHS = {"dense": "qwen2.5-3b", "moe": "qwen3-moe-235b-a22b",
                "ssm": "mamba2-130m", "hybrid": "zamba2-7b",
                "vlm": "llava-next-mistral-7b", "audio": "musicgen-medium"}
# the leaves whose serving placement is not JAX's (``serve_param_specs``):
# the attention blocks of every config whose KV heads do not divide a
# 16-wide model axis (they run whole heads), and the SSM blocks JAX splits
_ATTN = {f"layers/attn/{w}/{f}" for w in ("wq", "wk", "wv")
         for f in ("packed", "scale")} | {"layers/attn/wo/packed"}
_BIAS = {f"layers/attn/{w}/bias" for w in ("wq", "wk", "wv")}
SERVE_DIFFERS = {
    "gemma3-27b": set(),
    "mistral-large-123b": _ATTN,
    "starcoder2-15b": _ATTN,
    "qwen2.5-3b": _ATTN | _BIAS,
    "llava-next-mistral-7b": _ATTN,
    "mamba2-130m": {"layers/ssm/out_proj/packed"},
    "zamba2-7b": {"layers/ssm/in_proj/packed", "layers/ssm/in_proj/scale",
                  "layers/ssm/out_proj/packed"},
    "musicgen-medium": _ATTN,
    "llama4-scout-17b-a16e": _ATTN,
    "qwen3-moe-235b-a22b": _ATTN,
}


def _fake_mesh(shape, names):
    class FakeMesh:
        axis_names = names

    FakeMesh.shape = dict(zip(names, shape))
    return FakeMesh()


def _divisor(spec, sizes) -> int:
    out = 1
    for entry in spec:
        for axis in ((entry,) if isinstance(entry, str) else (entry or ())):
            out *= sizes[axis]
    return out


def _jax_name(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                                                  getattr(k, "idx", k))))
                    for k in path)


# ------------------------------------------------------- FSDP bytes
@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_fsdp_train_cell_bytes_match_jax(arch, shape):
    names = MESHES[shape]
    fake = _fake_mesh(shape, names)
    ap = j_abstract_params(j_get_arch(arch))
    aopt = jax.eval_shape(j_make_optimizer("adamw")[0], ap)
    want = 0
    for tree in (ap, aopt):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            spec = _with_fsdp(param_spec(path, leaf, fake), leaf, fake)
            want += (math.prod(leaf.shape) * leaf.dtype.itemsize
                     // _divisor(spec, fake.shape))
    run = tbase.RunConfig(model=get_arch(arch),
                          shape=tbase.SHAPES["train_4k"])
    _, (params, opt, ef, batch) = train_cell(run, dry_mesh(shape, names))
    got = sum(t.untyped_storage().nbytes() for t in _tensors((params, opt)))
    assert got == want
    assert ef == {} and batch["tokens"].shape[0] == 256


# ------------------------------------------------------ serve bytes
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serve_cell_bytes_match_jax_where_the_specs_do(arch):
    fake = _fake_mesh((16, 16), ("data", "model"))
    sizes = fake.shape
    jspecs, jbytes = {}, {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            j_abstract_params(j_get_arch(arch), 4))[0]:
        spec = tuple(param_spec(path, leaf, fake))
        spec += (None,) * (leaf.ndim - len(spec))
        name = _jax_name(path)
        stacked = name.startswith("layers/")
        jspecs[name] = spec[1:] if stacked else spec
        jbytes[name] = (math.prod(leaf.shape) * leaf.dtype.itemsize
                        // _divisor(spec, sizes))
    cfg = get_arch(arch)
    mesh = dry_mesh((16, 16), ("data", "model"))
    local = sharded_abstract_params(cfg, mesh, 4)
    from repro_torch.dist.sharding import meta_params

    specs = serve_param_specs(fake, meta_params(cfg, 4), cfg)
    got, differs = {}, set()

    def one(path, leaf, spec):
        layer = path[0] == "layers"
        name = "/".join(map(str, (("layers",) + tuple(path[2:])) if layer
                            else path))
        got[name] = got.get(name, 0) + leaf.untyped_storage().nbytes()
        if jspecs[name] != tuple(spec):
            differs.add(name)

    tree_map_with_path(one, local, specs)
    assert set(got) == set(jspecs)
    assert differs == SERVE_DIFFERS[arch]
    for name in set(got) - differs:
        assert got[name] == jbytes[name], name


# ---------------------------------------------------- batch specs
@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_synthetic_batch_specs_match_jax(family):
    arch = FAMILY_ARCHS[family]
    want = j_batch_specs(j_get_arch(arch), 4, 32)
    got = synthetic_batch_specs(get_arch(arch), 4, 32)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape)
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype)


# ------------------------------------------- dry run = real mesh
_CELLS = {"paged_serve": ("decode", {"paged": True}),
          "chunked_prefill": ("prefill", {"chunked": True})}


def _run(cfg):
    eng = tbase.EngineConfig(weight_bits=4, kv_bits=8, backend="cuda",
                             attn_backend="cuda")
    return {name: tbase.RunConfig(
        model=cfg, shape=tbase.ShapeConfig(name, kind, 64, 4),
        serve=tbase.ServeConfig(engine=eng, page_size=8, prefill_chunk=16))
        for name, (kind, _) in _CELLS.items()}


def test_dry_mesh_tallies_what_two_gloo_ranks_move(tmp_path):
    cfg = dataclasses.replace(get_reduced("qwen2.5-3b"), dtype="float32")
    torch.save({"runs": _run(cfg), "cells": _CELLS}, tmp_path / "case.pt")
    res = run_ranks(tmp_path, 2, """
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline import counted_costs
    case = torch.load(os.path.join(OUT, "case.pt"), weights_only=False)
    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        for name, run in case["runs"].items():
            fn, args, _ = build_cell(run, mesh, abstract=False, device="cpu",
                                     **dict(case["cells"][name][1]))
            c = counted_costs(fn, *args)
            out[shape, name] = (c["collectives"], c["priced"])
    put(out)
    """)
    for shape in ((1, 2), (2, 1)):
        for rank in range(2):
            mesh = dry_mesh(shape, ("data", "model"), rank=rank)
            for name, run in _run(cfg).items():
                fn, args, _ = build_cell(run, mesh, **dict(_CELLS[name][1]))
                c = counted_costs(fn, *args)
                coll, priced = res[rank][shape, name]
                assert c["collectives"] == coll, (shape, name, rank)
                assert c["priced"] == priced, (shape, name, rank)
                if shape == (1, 2):
                    assert coll["all-reduce"] > 0 and coll["all-gather"] > 0
                else:
                    assert coll["total"] == 0


# ---------------------------------------------------------- the CLI
_JAX_FIELDS = {
    "arch", "shape", "mesh", "multi_pod", "kind", "engine_bits",
    "engine_radix", "kv_bits", "engine_backend", "attn_backend",
    "engine_sharded", "psum_bits", "split_local", "paged", "chunked_prefill",
    "remat", "microbatches", "grad_compress_bits", "tag", "n_devices",
    "flops_per_device", "bytes_per_device", "collective_bytes_per_device",
    "regions", "compute_s", "memory_s", "collective_s", "dominant",
    "bound_seconds", "memory_analysis", "model_flops_total",
    "useful_flops_ratio", "ideal_compute_s", "ideal_memory_s",
    "roofline_fraction"}


@pytest.mark.parametrize("shape,kw", [
    ("decode_32k", dict(paged=True, engine_bits=4, kv_bits=8)),
    ("prefill_32k", dict(chunked_prefill=True)),
    ("train_4k", {}),
], ids=["decode", "chunked", "train"])
def test_run_cell_writes_jax_fields(tmp_path, monkeypatch, shape, kw):
    import repro_torch.config as config

    monkeypatch.setattr(config, "get_arch", get_reduced)
    rec = dryrun.run_cell("qwen2.5-3b", shape, out_dir=str(tmp_path), **kw)
    assert _JAX_FIELDS <= set(rec)
    assert "count_s" in rec and "lower_s" not in rec
    assert rec["mesh"] == [16, 16] and rec["n_devices"] == 256
    assert set(rec["memory_analysis"]) >= {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes"}
    files = list(tmp_path.glob("qwen2.5-3b__*.json"))
    assert len(files) == 1
    assert rec["bound_seconds"] == max(rec["compute_s"], rec["memory_s"],
                                       rec["collective_s"])


def test_long_500k_on_full_attention_exits_as_jax(tmp_path):
    with pytest.raises(SystemExit, match="long_500k is skipped"):
        dryrun.run_cell("qwen2.5-3b", "long_500k", out_dir=str(tmp_path))


def test_full_width_dry_run_cli(tmp_path):
    t0 = time.perf_counter()
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--paged",
                 "--engine-bits", "4", "--kv-bits", "8", "--out",
                 str(tmp_path)])
    assert time.perf_counter() - t0 < 20
    path = tmp_path / "qwen2.5-3b__decode_32k__pod__eng4r1__kv8__paged.json"
    rec = __import__("json").loads(path.read_text())
    assert rec["engine_backend"] == "cuda" and rec["attn_backend"] == "cuda"
    assert rec["priced"] == {"bitplane_gemv/decode": 252,
                             "paged_decode_attention": 36}
    assert rec["dominant"] == "memory_s"


def test_build_cell_names_each_kind():
    cfg = get_reduced("qwen2.5-3b")
    mesh = dry_mesh((1, 1), ("data", "model"))
    for name, kind, kw in (("t", "train", {}), ("p", "prefill", {}),
                           ("c", "prefill", {"chunked": True}),
                           ("d", "decode", {}),
                           ("dp", "decode", {"paged": True})):
        run = tbase.RunConfig(model=cfg,
                              shape=tbase.ShapeConfig(name, kind, 32, 2))
        fn, args, got = build_cell(run, mesh, **kw)
        assert got == kind
        assert counted_costs(fn, *args)["flops"] > 0
