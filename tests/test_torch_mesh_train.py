"""PyTorch port vs JAX: the full-sequence path and training on a
``(data, model)`` mesh of ranks, GPipe over ``pod`` and the elastic
shrink.

One spawned group of 8 ``gloo`` ranks (``test_torch_dist.RANK_PRELUDE``)
runs every case while this process computes the JAX references; the
sub-meshes ``(2, 2)``, ``(1, 2)`` and ``(2, 1)`` are laid over the first
ranks (``make_mesh(ranks=)``).  Reduced configs in float32 on JAX's
``init_params`` weights (``params_from_numpy``); the placement is
``serve_param_specs`` (whole heads, experts over ``model``, SSM blocks
whole), the batch is split over the data shards by ``batch_shardings``.

* ``forward(mesh=)`` / ``prefill(mesh=)`` for the six families at
  ``(2, 4)`` and ``(4, 2)``, on the ``cuda`` attention backend with the
  flash threshold lowered to the 16-token prompts (so attention takes the
  flash route and the ssm layers the SSD scan's, whose wrappers run the
  plain versions on CPU tensors): logits (gathered over the data shards),
  the moe aux loss and the filled slots cache (gathered over heads and
  lanes) against JAX's single-device ``forward`` / ``prefill`` within
  rtol = atol = 2e-4 (``tests/test_dist.py``'s serving bound).
* ``make_train_step(mesh=)``, two AdamW steps (lr 1e-3, warmup 2) from
  the same weights on the same batches (B 4, S 16), against JAX's
  single-device step at JAX's own bounds (``tests/test_dist.py:155``:
  loss within rel 1e-4, params within rtol = atol = 2e-3), and against
  the port's single-device step within :data:`PORT_TOL` (loss and grad
  norm rel 1e-5, params atol 1e-4, a tenth of lr: the float32 sums run in
  another order, and an element whose gradient sits at rounding noise
  moves by another fraction of lr in Adam's step; the moe and the
  compression cases measured 6.7e-5 at one element each; and the change
  of all params, ``||Δ_mesh - Δ_one|| / ||Δ_one||``, within 1e-3, which
  reads 1 for a step that left them unchanged and read 1.9e-5 to 1.9e-4
  over the cases here, the compression case the largest).  Dense
  at ``(2, 4)``, ``(1, 2)`` and ``(2, 1)``; moe, ssm, hybrid, vlm and
  audio at ``(2, 2)``; moe with two microbatches at ``(2, 2)``;
  Adafactor with a clip that bites and two microbatches at ``(2, 2)``;
  int8 error-feedback compression with two microbatches at ``(2, 4)``;
  FSDP (``make_train_step(mode="fsdp")``: params and AdamW state stored
  as ``mesh_specs(mode="fsdp")`` places them, gathered a layer at a time)
  for dense and moe at ``(2, 2)``, at the same bounds.  Every rank reports the same metrics, and a
  leaf whole on every model rank gets bit-equal gradients on all ranks.
* ``pipeline_apply`` over ``(2, 2, 2)`` (``tests/test_pipeline.py``'s
  case: L 8, D 16, B 8, M 4, S 2): forward within 1e-5 and gradients
  within 1e-4 of the sequential sweep, M + S - 1 permutes forward and
  one fewer backward on every rank.
* ``ElasticMeshManager``: ``plan_shrink`` equal to JAX's over a grid of
  losses, and the drill: one step at ``(2, 2)``, ``reshard`` onto the
  ``(1, 2)`` survivors, a step there with ``grad_accum_factor``
  microbatches, equal (within :data:`PORT_TOL`) to an unbroken ``(1, 2)``
  run with that many microbatches.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import MeshConfig as JMeshConfig
from repro.config.base import TrainConfig as JTrainConfig
from repro.ft import ElasticMeshManager as JElastic
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models.transformer import prefill as j_prefill
from repro.optim import ef_state_init as j_ef_init
from repro.optim import make_optimizer as j_make_optimizer
from repro.train.trainer import make_train_step as j_make_train_step

from repro_torch.config import MeshConfig, TrainConfig
from repro_torch.data import DataPipeline
from repro_torch.ft import ElasticMeshManager
from repro_torch.optim import ef_state_init, make_optimizer
from repro_torch.train import make_train_step
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import params_from_numpy, stack_layers

from conftest import make_batch
from test_torch_dist import RANK_PRELUDE, ROOT
from test_torch_model import jax_params_to_numpy, torch_cfg
from test_torch_train import _jax_model

torch.set_num_threads(1)

SEQ_TOL = dict(rtol=2e-4, atol=2e-4)
JAX_LOSS_RTOL, JAX_PARAM_TOL = 1e-4, dict(rtol=2e-3, atol=2e-3)
PORT_TOL = dict(loss_rtol=1e-5, param_atol=1e-4, change_rtol=1e-3)
FAMILIES = {"dense": "qwen2.5-3b", "moe": "qwen3-moe-235b-a22b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-7b",
            "vlm": "llava-next-mistral-7b", "audio": "musicgen-medium"}
SEQ_MESHES = ("2x4", "4x2")
# label -> (shape, world ranks)
MESHES = {"2x4": ((2, 4), None), "4x2": ((4, 2), None),
          "2x2": ((2, 2), [0, 1, 2, 3]), "1x2": ((1, 2), [0, 1]),
          "2x1": ((2, 1), [0, 1])}
B, S, STEPS = 4, 16, 2
SEQ_MAX_LEN = 40     # 16 tokens after llava's 16 image positions
TRAIN_KW = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# name -> (mesh, family, TrainConfig options)
TRAIN_CASES = {
    "dense_2x4": ("2x4", "dense", {}),
    "dense_1x2": ("1x2", "dense", {}),
    "dense_2x1": ("2x1", "dense", {}),
    **{f"{fam}_2x2": ("2x2", fam, {})
       for fam in ("moe", "ssm", "hybrid", "vlm", "audio")},
    # moe's aux loss is not linear in which rows share a microbatch: the
    # global batch is split into microbatches first, as JAX's step has it
    "moe_microbatches_2x2": ("2x2", "moe", dict(microbatches=2)),
    "adafactor_clip_2x2": ("2x2", "dense", dict(
        optimizer="adafactor", grad_clip=0.05, microbatches=2)),
    "compress_2x4": ("2x4", "dense", dict(grad_compress_bits=8,
                                         microbatches=2)),
}
# FSDP cases: name -> (mesh, family, TrainConfig options)
FSDP_CASES = {"fsdp_dense_2x2": ("2x2", "dense", {}),
              "fsdp_moe_2x2": ("2x2", "moe", {})}
ELASTIC_ARCH = "qwen2.5-3b"


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX cfg, JAX params, port cfg, port per-layer params)."""
    cfg, jp = _jax_model(arch)
    tcfg = torch_cfg(cfg)
    return cfg, jp, tcfg, params_from_numpy(jax_params_to_numpy(jp), tcfg,
                                            device="cpu")


def _seq_batch(arch):
    cfg = _model(arch)[0]
    return {k: np.asarray(v) for k, v in
            make_batch(cfg, jax.random.PRNGKey(1), batch=B, seq=S).items()
            if k != "labels"}


def _train_batches(arch):
    return [DataPipeline(_model(arch)[2], batch=B, seq_len=S,
                         seed=4).batch_at(i) for i in range(STEPS)]


def _train_kw(options):
    return dict(TRAIN_KW, **options)


RANK_CODE = """
from types import SimpleNamespace
from repro_torch.config import TrainConfig
from repro_torch.dist import (batch_shardings, local_shard,
                              serve_param_specs, use_mesh)
from repro_torch.dist.collectives import P2P_CALLS, all_gather, all_reduce
from repro_torch.dist.pipeline import microbatch, pipeline_apply, stack_stages
from repro_torch.ft import ElasticMeshManager
import repro_torch.models.transformer as tt
from repro_torch.models import forward, init_cache, prefill
from repro_torch.models.transformer import rank_view
from repro_torch.optim import OptState, ef_state_init, make_optimizer
from repro_torch.dist.sharding import gather_shards
from repro_torch.train.trainer import (_make_grads, make_train_step,
                                       mesh_specs, shard_train_state)
from repro_torch.tree import tree_map
from repro_torch.weights import stack_layers

case = torch.load(os.path.join(OUT, "case.pt"), weights_only=False)
# the 16-token prompts take the flash route (and the ssm layers the SSD
# scan's): on CPU tensors the kernels' wrappers run their plain versions
tt.FLASH_THRESHOLD = 16
meshes = {label: make_mesh(shape, ("data", "model"), device="cpu",
                           ranks=ranks)
          for label, (shape, ranks) in case["meshes"].items()}
pipe_mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
out = {"seq": {}, "train": {}, "grads": {}, "elastic": {}}


def gather(t, group, dim, whole):
    return all_gather(t, group, dim) if t.shape[dim] < whole else t


for label, arch in case["seq"]:
    mesh = meshes[label]
    cfg, params = case["models"][arch]
    batch = {k: torch.from_numpy(v) for k, v in case["seq_batch"][arch].items()}
    local = local_shard(params, serve_param_specs(mesh, params, cfg), mesh)
    lb = local_shard(batch, batch_shardings(mesh, batch), mesh)
    data = mesh.group(mesh.data_axes())
    logits, aux = forward(local, lb, cfg, attn_backend="cuda", mesh=mesh)
    view = rank_view(local, cfg, mesh)
    cache = init_cache(cfg, lb["tokens"].shape[0], case["seq_max_len"],
                       device="cpu", n_kv_heads=view.hkv)
    last, cache = prefill(local, lb, cfg, cache, attn_backend="cuda",
                          mesh=mesh)
    filled = {}
    for name in ("k", "v", "conv", "h"):
        if name in cache:
            t = cache[name]
            if name in ("k", "v"):
                t = gather(t, mesh.group("model"), 3, cfg.n_kv_heads)
            filled[name] = all_gather(t, data, 1)
    out["seq"][label, arch] = dict(
        logits=all_gather(logits, data, 0), aux=aux,
        last=all_gather(last, data, 0), cache=filled,
        pos=all_gather(cache["pos"], data, 0), hkv=view.hkv)


def train_state(cfg, tcfg, params, mesh, mode="tp"):
    sp = tree_map(lambda t: t.clone(), stack_layers(params))
    init_fn, _ = make_optimizer(tcfg.optimizer)
    opt = init_fn(sp)
    ef = ef_state_init(sp) if tcfg.grad_compress_bits else {}
    specs = mesh_specs(cfg, tcfg, mesh, mode=mode)
    return specs, shard_train_state(specs, mesh, sp, opt, ef)


def gather_train_state(specs, mesh, params, opt_state, ef_state):
    return (gather_shards(params, specs["params"], mesh),
            OptState(opt_state.step,
                     gather_shards(opt_state.inner, specs["opt"], mesh)),
            gather_shards(ef_state, specs["ef"], mesh) if ef_state
            else ef_state)


def run_steps(step, state, batches):
    metrics = []
    for b in batches:
        p, o, e, m = step(*state, b)
        state = (p, o, e)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


for name, (label, arch, kw, mode) in case["train"].items():
    mesh = meshes[label]
    if mesh is None:
        continue
    cfg, params = case["models"][arch]
    tcfg = TrainConfig(**kw)
    specs, state = train_state(cfg, tcfg, params, mesh, mode)
    state, metrics = run_steps(make_train_step(cfg, tcfg, mesh=mesh,
                                               mode=mode), state,
                               case["train_batches"][arch])
    whole = gather_train_state(specs, mesh, *state)
    out["train"][name] = dict(metrics=metrics,
                              params=whole[0] if mesh.rank == 0 else None,
                              opt=whole[1].inner if mesh.rank == 0 else None,
                              ef=whole[2] if mesh.rank == 0 else None)

# the gradients of the leaves every model rank holds whole
mesh = meshes["2x2"]
if mesh is not None:
    cfg, params = case["models"][case["grads_arch"]]
    tcfg = TrainConfig(**case["train_kw"])
    specs, state = train_state(cfg, tcfg, params, mesh)
    grads, _ = _make_grads(cfg, tcfg, mesh)[0](
        state[0], case["train_batches"][case["grads_arch"]][0])
    whole = {}

    def keep(path, g, spec):
        if all(e is None or mesh.count(e) == 1 for e in spec):
            whole["/".join(map(str, path))] = g

    from repro_torch.dist.sharding import tree_map_with_path
    tree_map_with_path(keep, grads, specs["params"])
    out["grads"] = whole

# GPipe over pod
Ws, x = (torch.from_numpy(a) for a in case["pipe"])


def stage_fn(local_w, h):
    for w in local_w:
        h = torch.tanh(h @ w)
    return h


with use_mesh(pipe_mesh):
    staged = stack_stages(Ws, 2).clone().requires_grad_(True)
    calls = P2P_CALLS[0]
    y = pipeline_apply(staged, microbatch(x, 4), stage_fn, n_stages=2)
    fwd = P2P_CALLS[0] - calls
    (y ** 2).sum().backward()
    bwd = P2P_CALLS[0] - calls - fwd
    # each stage's gradient lives on its own pod rank: summed over pod
    grad = all_reduce(staged.grad, pipe_mesh.group("pod"))
out["pipe"] = dict(y=y.detach(), grad=grad, fwd=fwd, bwd=bwd)

# elastic: (2, 2) loses a node of 2 ranks and shrinks to (1, 2)
cfg, params = case["models"][case["elastic_arch"]]
batches = case["train_batches"][case["elastic_arch"]]
old, new = meshes["2x2"], meshes["1x2"]
plan = ElasticMeshManager(SimpleNamespace(
    shape=(2, 2), axis_names=("data", "model"))).plan_shrink(
        lost_nodes=1, chips_per_node=2)
if old is not None:
    tcfg = TrainConfig(**case["train_kw"])
    specs, state = train_state(cfg, tcfg, params, old)
    state, m1 = run_steps(make_train_step(cfg, tcfg, mesh=old), state,
                          batches[:1])
    p, o, _ = state
    p = ElasticMeshManager.reshard(
        p, old, new, lambda m: mesh_specs(cfg, tcfg, m)["params"])
    inner = ElasticMeshManager.reshard(
        o.inner, old, new, lambda m: mesh_specs(cfg, tcfg, m)["opt"])
    if new is not None:
        tcfg2 = TrainConfig(**dict(
            case["train_kw"], microbatches=plan.grad_accum_factor))
        state, m2 = run_steps(make_train_step(cfg, tcfg2, mesh=new),
                              (p, OptState(o.step, inner), {}), batches[1:])
        whole = gather_train_state(mesh_specs(cfg, tcfg2, new), new, *state)
        # the unbroken run: both steps on (1, 2)
        specs, ref = train_state(cfg, tcfg2, params, new)
        ref, mref = run_steps(make_train_step(cfg, tcfg2, mesh=new), ref,
                              batches)
        ref = gather_train_state(specs, new, *ref)
        out["elastic"] = dict(plan=plan, metrics=m1 + m2, ref_metrics=mref,
                              params=whole[0], ref_params=ref[0])
put(out)
"""


def _start_ranks(tmp_path, world, code):
    """Start ``code`` in ``world`` processes of one ``gloo`` group;
    returns ``finish(timeout)``, which waits for them and returns their
    results in rank order (a rank that fails or outlives ``timeout``
    fails the test, and every process is stopped)."""
    prog = tmp_path / "rank_prog.py"
    prog.write_text(RANK_PRELUDE.format(src=str(ROOT / "src"))
                    + textwrap.dedent(code))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(prog), str(r), str(world), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]

    def finish(timeout):
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

    return finish


# ------------------------------------------------------------ references
def _jax_seq(arch):
    cfg, jp, _, _ = _model(arch)
    batch = {k: jnp.asarray(v) for k, v in _seq_batch(arch).items()}
    logits, aux = j_forward(jp, batch, cfg)
    cache = j_init_cache(cfg, B, SEQ_MAX_LEN)
    last, cache = j_prefill(jp, batch, cfg, cache)
    return dict(logits=np.asarray(logits), aux=float(aux),
                last=np.asarray(last),
                cache={k: np.asarray(v) for k, v in cache.items()})


def _jax_steps(arch, options):
    cfg, jp, _, _ = _model(arch)
    jtc = JTrainConfig(**_train_kw(options))
    init, _ = j_make_optimizer(jtc.optimizer)
    jo = init(jp)
    jef = j_ef_init(jp) if jtc.grad_compress_bits else {}
    step = j_make_train_step(cfg, jtc, donate=False)
    metrics = []
    for b in _train_batches(arch):
        jp, jo, jef, m = step(jp, jo, jef,
                              {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.leaves(jp), metrics


def _port_steps(arch, options):
    _, _, tcfg, params = _model(arch)
    ttc = TrainConfig(**_train_kw(options))
    tp = tree_map(lambda t: t.clone(), stack_layers(params))
    to = make_optimizer(ttc.optimizer)[0](tp)
    tef = ef_state_init(tp) if ttc.grad_compress_bits else {}
    step = make_train_step(tcfg, ttc)
    metrics = []
    for b in _train_batches(arch):
        tp, to, tef, m = step(tp, to, tef, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return tp, metrics


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 8 ranks' results, with the JAX and single-device references
    computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    archs = sorted(set(FAMILIES.values()))
    rng = np.random.default_rng(0)
    pipe = ((rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32),
            rng.standard_normal((8, 16)).astype(np.float32))
    torch.save({
        "meshes": MESHES,
        "models": {a: (_model(a)[2], _model(a)[3]) for a in archs},
        "seq": [(label, a) for label in SEQ_MESHES for a in archs],
        "seq_batch": {a: _seq_batch(a) for a in archs},
        "seq_max_len": SEQ_MAX_LEN,
        "train": {name: (label, FAMILIES[fam], _train_kw(opts),
                         "fsdp" if name in FSDP_CASES else "tp")
                  for name, (label, fam, opts) in {
                      **TRAIN_CASES, **FSDP_CASES}.items()},
        "train_batches": {a: _train_batches(a) for a in archs},
        "train_kw": TRAIN_KW, "grads_arch": ELASTIC_ARCH,
        "elastic_arch": ELASTIC_ARCH, "pipe": pipe,
    }, tmp / "case.pt")
    finish = _start_ranks(tmp, 8, RANK_CODE)
    refs = {"seq": {a: _jax_seq(a) for a in archs}, "jax": {}, "port": {}}
    for name, (_, fam, opts) in {**TRAIN_CASES, **FSDP_CASES}.items():
        key = (FAMILIES[fam], tuple(sorted(opts.items())))
        if key not in refs["jax"]:
            refs["jax"][key] = _jax_steps(FAMILIES[fam], opts)
            refs["port"][key] = _port_steps(FAMILIES[fam], opts)
    return finish(420), refs, pipe


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("mesh", SEQ_MESHES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_and_prefill_match_jax(run, family, mesh):
    res, refs, _ = run
    arch = FAMILIES[family]
    want = refs["seq"][arch]
    cfg = _model(arch)[2]
    for r, out in enumerate(res):
        got = out["seq"][mesh, arch]
        msg = f"{family} {mesh} rank {r}"
        np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                                   **SEQ_TOL, err_msg=msg)
        np.testing.assert_allclose(float(got["aux"]), want["aux"],
                                   **SEQ_TOL, err_msg=msg)
        np.testing.assert_allclose(got["last"].numpy(), want["last"],
                                   **SEQ_TOL, err_msg=msg)
        for name, t in got["cache"].items():
            np.testing.assert_allclose(t.numpy(), want["cache"][name],
                                       **SEQ_TOL, err_msg=f"{msg} {name}")
        assert set(got["cache"]) == set(want["cache"]) - {"pos"}
        assert (got["pos"].numpy() == want["cache"]["pos"]).all()
    # heads over model where the KV heads divide it
    msize = int(mesh[-1])
    if cfg.family != "ssm":
        hkv = res[0]["seq"][mesh, arch]["hkv"]
        assert hkv == (cfg.n_kv_heads // msize
                       if cfg.n_kv_heads % msize == 0 else cfg.n_kv_heads)


def change_rel_err(got, want, start):
    """``||(got - start) - (want - start)|| / ||want - start||`` over all
    leaves: how far one run's change of the params is from another's
    (1.0 for a run that left them unchanged)."""
    num = sum(float(torch.sum(torch.square(g.double() - w.double())))
              for g, w in zip(got, want))
    den = sum(float(torch.sum(torch.square(w.double() - s.double())))
              for w, s in zip(want, start))
    return (num / den) ** 0.5


def _check_train(res, refs, name):
    label, fam, opts = {**TRAIN_CASES, **FSDP_CASES}[name]
    key = (FAMILIES[fam], tuple(sorted(opts.items())))
    jleaves, jmetrics = refs["jax"][key]
    tparams, tmetrics = refs["port"][key]
    shape, ranks = MESHES[label]
    members = ranks if ranks is not None else range(8)
    got = [res[r]["train"][name] for r in members]
    for g in got[1:]:
        assert g["metrics"] == got[0]["metrics"], name
    lead = got[0]
    for m, jm, tm in zip(lead["metrics"], jmetrics, tmetrics):
        assert abs(m["loss"] - jm["loss"]) <= JAX_LOSS_RTOL * abs(jm["loss"])
        np.testing.assert_allclose(m["loss"], tm["loss"],
                                   rtol=PORT_TOL["loss_rtol"])
        np.testing.assert_allclose(m["grad_norm"], tm["grad_norm"],
                                   rtol=PORT_TOL["loss_rtol"])
        assert m["lr"] == tm["lr"]
    leaves = tree_leaves(lead["params"])
    assert len(leaves) == len(jleaves)
    for a, j, t in zip(leaves, jleaves, tree_leaves(tparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), **JAX_PARAM_TOL)
        np.testing.assert_allclose(a.numpy(), t.numpy(), rtol=0,
                                   atol=PORT_TOL["param_atol"])
    rel = change_rel_err(leaves, tree_leaves(tparams),
                         tree_leaves(stack_layers(_model(FAMILIES[fam])[3])))
    assert rel <= PORT_TOL["change_rtol"], (name, rel)
    return lead


@pytest.mark.parametrize("name", [n for n in TRAIN_CASES
                                  if not n.startswith(("adafactor",
                                                       "compress"))])
def test_train_step_matches_jax(run, name):
    res, refs, _ = run
    _check_train(res, refs, name)


@pytest.mark.parametrize("name", list(FSDP_CASES))
def test_fsdp_train_step_matches_jax(run, name):
    res, refs, _ = run
    _check_train(res, refs, name)


def test_adafactor_and_a_clip_that_bites_match_jax(run):
    """Adafactor's factored means and update RMS over whole leaves split
    over ``model`` (columns and rows), under a clip that bites, with two
    microbatches."""
    res, refs, _ = run
    lead = _check_train(res, refs, "adafactor_clip_2x2")
    assert all(m["grad_norm"] > 0.05 for m in lead["metrics"])
    assert any("vr" in str(k) for k in _paths(lead["opt"]))


def test_compressed_grads_match_jax(run):
    """int8 error feedback on the reduced gradients, each split leaf with
    the whole leaf's absmax; the error-feedback buffer gathered back
    equals the port's single-device buffer's shape."""
    res, refs, _ = run
    lead = _check_train(res, refs, "compress_2x4")
    assert len(tree_leaves(lead["ef"])) == len(tree_leaves(lead["params"]))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix


def test_whole_leaves_get_equal_grads_on_every_rank(run):
    """Every leaf held whole on the model ranks (norms, SSM-free here:
    the dense config's norms and biases) ends the backward pass with the
    same gradient, bit for bit, on all four ranks of ``(2, 2)``."""
    res, _, _ = run
    grads = [res[r]["grads"] for r in range(4)]
    assert grads[0] and any("norm" in k for k in grads[0])
    for g in grads[1:]:
        assert g.keys() == grads[0].keys()
        for k in g:
            assert torch.equal(g[k], grads[0][k]), k


def test_pipeline_matches_sequential(run):
    res, _, (ws, x) = run
    wt, xt = torch.from_numpy(ws), torch.from_numpy(x)

    def stage_fn(w, h):
        for wi in w:
            h = torch.tanh(h @ wi)
        return h

    ref = stage_fn(wt, xt)
    w = wt.clone().requires_grad_(True)
    (stage_fn(w, xt) ** 2).sum().backward()
    for r, out in enumerate(res):
        p = out["pipe"]
        assert float((p["y"].reshape(8, 16) - ref).abs().max()) < 1e-5, r
        assert float((p["grad"].reshape(8, 16, 16)
                      - w.grad).abs().max()) < 1e-4, r
        # M + S - 1 permutes forward; backward, all but the last tick's
        assert (p["fwd"], p["bwd"]) == (5, 4), r


def test_pipeline_without_a_pod_mesh_is_the_sequential_sweep():
    from repro_torch.dist.pipeline import (microbatch, pipeline_apply,
                                           stack_stages)

    rng = np.random.default_rng(1)
    ws = torch.from_numpy(rng.standard_normal((4, 8, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))

    def stage_fn(w, h):
        for wi in w:
            h = torch.tanh(h @ wi)
        return h

    y = pipeline_apply(stack_stages(ws, 2), microbatch(x, 2), stage_fn,
                       n_stages=2)
    assert torch.equal(y.reshape(4, 8), stage_fn(ws, x))
    assert microbatch(x, 2).shape == (2, 2, 8)
    with pytest.raises(ValueError):
        microbatch(x, 3)
    with pytest.raises(ValueError):
        stack_stages(ws, 3)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_plan_shrink_matches_jax(multi_pod):
    port = ElasticMeshManager(MeshConfig(multi_pod=multi_pod))
    ref = JElastic(JMeshConfig(multi_pod=multi_pod))
    for chips in (1, 2, 4, 8):
        for lost in (0, 1, 3, 8, 16, 33, 64, 100, 127, 200):
            try:
                want = ref.plan_shrink(lost, chips)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    port.plan_shrink(lost, chips)
                continue
            assert dataclasses.asdict(port.plan_shrink(lost, chips)) == \
                dataclasses.asdict(want), (lost, chips)


def test_elastic_reshard_continues_the_run(run):
    res, _, _ = run
    for r in (0, 1):
        e = res[r]["elastic"]
        assert (e["plan"].new_shape, e["plan"].grad_accum_factor) == \
            ((1, 2), 2)
        for m, ref in zip(e["metrics"], e["ref_metrics"]):
            np.testing.assert_allclose(m["loss"], ref["loss"],
                                       rtol=PORT_TOL["loss_rtol"])
        for a, b in zip(tree_leaves(e["params"]),
                        tree_leaves(e["ref_params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=PORT_TOL["param_atol"])
    assert all(res[r]["elastic"] == {} for r in range(2, 8))
