"""PyTorch port vs JAX: training — ``loss_fn`` and ``chunked_ce``,
``forward(remat=)``, ``make_train_step`` for the six families, the
optimizers and gradient compression inside the step, microbatching,
``Trainer``'s restart drill, training checkpoints across the two
packages, the ``train_lm`` driver and the straggler monitor; and the
kernel wrappers' refusal to run under autograd.

Both packages get the same weights (JAX ``init_params(cfg, PRNGKey(0))``
handed over through numpy and ``params_from_numpy``, then stacked into
the training layout with ``stack_layers``) and the same batches (the
pipelines are bit-identical, ``tests/test_torch_data.py``); reduced
configs in float32.

Tolerances: losses and grad norms within rtol 1e-5 (float32 sums in
another order); gradients within atol 5e-6 plus rtol 1e-5 (an embedding
row sums its tokens' gradients in another order: the moe family's, with
the routing's paths, reach 2.3e-6 where the others stay under 1e-6);
params after
updates within atol 2 * lr: Adam's first step moves a parameter by about
lr * sign(g) whatever |g|, so a gradient at float32 noise may move it
either way.  The port's own invariants (remat against none, microbatches
1 / 2 / 4, a resumed run against an uninterrupted one) within 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as jckpt
from repro.ckpt import CheckpointManager as JManager
from repro.config.base import TrainConfig as JTrainConfig
from repro.data import DataPipeline as JPipeline
from repro.ft import StragglerMonitor as JStraggler
from repro.models import forward as j_forward, init_params
from repro.models.transformer import chunked_ce as j_chunked_ce
from repro.models.transformer import loss_fn as j_loss_fn
from repro.optim import adamw_init as j_adamw_init
from repro.optim import ef_state_init as j_ef_init
from repro.optim import make_optimizer as j_make_optimizer
from repro.train import Trainer as JTrainer
from repro.train.trainer import clip_by_global_norm as j_clip
from repro.train.trainer import make_train_step as j_make_train_step

import repro_torch.ckpt.checkpoint as tckpt
import repro_torch.models.transformer as tt
from repro_torch.ckpt import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.data import DataPipeline
from repro_torch.ft import FailureInjector, StragglerMonitor
from repro_torch.optim import OptState, ef_state_init, make_optimizer
from repro_torch.train import Trainer, make_train_step
from repro_torch.train import trainer as ttrainer
from repro_torch.train.trainer import clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import params_from_numpy, stack_layers, \
    unstack_layers

from conftest import reduced_f32
from test_torch_cuda_kernels import GRAD_KERNELS, grad_cases
from test_torch_model import jax_params_to_numpy, torch_cfg

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-5, atol=5e-6)
FAMILIES = {"dense": "qwen2.5-3b", "moe": "qwen3-moe-235b-a22b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-7b",
            "vlm": "llava-next-mistral-7b", "audio": "musicgen-medium"}
B, S = 4, 16
TRAIN_KW = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    cfg = reduced_f32(arch, capacity_factor=8.0) if "moe" in arch else \
        reduced_f32(arch)
    return cfg, init_params(cfg, jax.random.PRNGKey(0))


def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params in the stacked
    layout), the port's a fresh copy."""
    cfg, jp = _jax_model(arch)
    tcfg = torch_cfg(cfg)
    tp = stack_layers(params_from_numpy(jax_params_to_numpy(jp), tcfg,
                                        device="cpu"))
    return cfg, jp, tcfg, tp


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _assert_trees_close(ttree, jtree, **tol):
    tl, jl = tree_leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(j, np.float32), **tol)


# ------------------------------------------------------------------ loss
def test_loss_fn_matches_jax():
    rng = np.random.default_rng(0)
    for shape in ((2, 5, 11), (2, 5, 3, 11)):           # dense, audio
        logits = rng.standard_normal(shape).astype(np.float32)
        labels = rng.integers(0, 11, shape[:-1]).astype(np.int32)
        t = tt.loss_fn(torch.from_numpy(logits), torch.from_numpy(labels),
                       torch.tensor(0.25))
        j = j_loss_fn(jnp.asarray(logits), jnp.asarray(labels), 0.25)
        np.testing.assert_allclose(float(t), float(j), **LOSS_TOL)


@pytest.mark.parametrize("arch,s,chunk", [
    ("qwen2.5-3b", 16, 4), ("qwen2.5-3b", 15, 4), ("qwen2.5-3b", 16, 512),
    ("musicgen-medium", 16, 8), ("llava-next-mistral-7b", 16, 8)])
def test_chunked_ce_matches_loss_fn_and_jax(arch, s, chunk):
    """The head per chunk (or, S not a multiple, ``loss_fn`` over the whole
    logits, as in JAX) equals ``loss_fn`` of the full logits and JAX's
    ``chunked_ce``, with the aux term added."""
    cfg, jp, tcfg, tp = _models(arch)
    b = DataPipeline(tcfg, batch=2, seq_len=s, seed=1).batch_at(0)
    hidden, _ = tt.forward(unstack_layers(tp), _tbatch(b), tcfg,
                           return_hidden=True, attn_backend="gather")
    got = tt.chunked_ce(tp, hidden, _tbatch(b)["labels"], tcfg,
                        chunk=chunk, aux=0.5)
    full = tt.loss_fn(tt._lm_logits(tp, hidden, tcfg, None),
                      _tbatch(b)["labels"], 0.5)
    np.testing.assert_allclose(float(got), float(full), rtol=1e-6)
    jh, _ = j_forward(jp, _jbatch(b), cfg, remat="none", return_hidden=True)
    want = j_chunked_ce(jp, jh, _jbatch(b)["labels"], cfg, chunk=chunk,
                        aux=0.5)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def _port_grads(tcfg, tp, batch, remat):
    """The port's loss and gradients in the stacked layout, as the train
    step takes them."""
    acc = tree_map(torch.zeros_like, tp)
    tree, pieces, slots = ttrainer._grad_pieces(tp, acc)
    hidden, aux = tt.forward(tree, batch, tcfg, remat=remat,
                             return_hidden=True, attn_backend="gather")
    loss = tt.chunked_ce(tree, hidden, batch["labels"], tcfg, aux=aux)
    grads = torch.autograd.grad(loss, pieces, allow_unused=True)
    for a, g in zip(slots, grads):
        if g is not None:
            a.add_(g)
    return loss.detach(), acc


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(family):
    """Loss and gradients of the training loss (remat on) against JAX's
    ``value_and_grad`` of the same loss."""
    cfg, jp, tcfg, tp = _models(FAMILIES[family])
    b = DataPipeline(tcfg, batch=B, seq_len=S, seed=2).batch_at(0)

    def j_loss(params, batch):
        hidden, aux = j_forward(params, batch, cfg, remat="block",
                                return_hidden=True)
        return j_chunked_ce(params, hidden, batch["labels"], cfg, aux=aux)

    jl, jg = jax.jit(jax.value_and_grad(j_loss))(jp, _jbatch(b))
    tl, tg = _port_grads(tcfg, tp, _tbatch(b), "block")
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)
    _assert_trees_close(tg, jg, **GRAD_TOL)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m", "zamba2-7b",
                                  "qwen3-moe-235b-a22b"])
def test_remat_gives_the_same_loss_and_grads(arch):
    _, _, tcfg, tp = _models(arch)
    b = _tbatch(DataPipeline(tcfg, batch=2, seq_len=S, seed=3).batch_at(0))
    l0, g0 = _port_grads(tcfg, tp, b, "none")
    l1, g1 = _port_grads(tcfg, tp, b, "block")
    assert float(l0) == float(l1)
    for x, y in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_remat_does_nothing_without_autograd():
    """Under ``no_grad`` (serving, scoring) no layer is checkpointed."""
    def fn(x):
        return x

    with torch.no_grad():
        assert tt._remat(fn, "block") is fn
    assert tt._remat(fn, "none") is fn
    assert tt._remat(fn, "block") is not fn


# ------------------------------------------------------------ train step
def _both_steps(arch, n_steps=3, mb=1, **kw):
    cfg, jp, tcfg, tp = _models(arch)
    jtc = JTrainConfig(**TRAIN_KW, microbatches=mb, **kw)
    ttc = TrainConfig(**TRAIN_KW, microbatches=mb, **kw)
    jinit, _ = j_make_optimizer(jtc.optimizer)
    tinit, _ = make_optimizer(ttc.optimizer)
    jo, to = jinit(jp), tinit(tp)
    jef = j_ef_init(jp) if jtc.grad_compress_bits else {}
    tef = ef_state_init(tp) if ttc.grad_compress_bits else {}
    jstep = j_make_train_step(cfg, jtc, donate=False)
    tstep = make_train_step(tcfg, ttc)
    pipe = JPipeline(cfg, batch=B, seq_len=S, seed=4)
    metrics = []
    for i in range(n_steps):
        b = pipe.batch_at(i)
        jp, jo, jef, jm = jstep(jp, jo, jef, _jbatch(b))
        tp, to, tef, tm = tstep(tp, to, tef, b)
        metrics.append((jm, tm))
    return (jp, jo, jef), (tp, to, tef), metrics, ttc


def _assert_steps_close(j, t, metrics, tcfg, norm_rtol=LOSS_TOL["rtol"]):
    for jm, tm in metrics:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(
                float(tm[k]), float(jm[k]), atol=0, err_msg=k,
                rtol=norm_rtol if k == "grad_norm" else LOSS_TOL["rtol"])
    _assert_trees_close(t[0], j[0], rtol=0, atol=2 * tcfg.lr)
    assert int(t[1].step) == int(j[1].step)


@pytest.mark.parametrize("family,mb", [("dense", 1), ("moe", 1),
                                       ("ssm", 2), ("hybrid", 2),
                                       ("vlm", 2), ("audio", 1)])
def test_train_step_matches_jax(family, mb):
    """Three steps of ``make_train_step`` (AdamW, warmup then cosine) from
    the same weights on the same batches: loss (the moe family's router
    aux included), grad norm and lr at each step, params after."""
    j, t, metrics, tcfg = _both_steps(FAMILIES[family], mb=mb)
    _assert_steps_close(j, t, metrics, tcfg)
    if family == "moe":
        assert all(float(tm["loss"]) > 0 for _, tm in metrics)


@pytest.mark.parametrize("kw", [dict(optimizer="adafactor"),
                                dict(optimizer="sgd"),
                                dict(grad_compress_bits=8),
                                dict(grad_clip=0.05)])
def test_train_step_options_match_jax(kw):
    """The other optimizers (Adafactor factors the stacked leaves as JAX
    does), int8 error-feedback compression (the buffer too) and a
    clipping norm that bites.  With compression, a float32 difference at
    a rounding tie of the int8 quantizer moves a code by one step
    (absmax / 127 of the leaf, under 1e-2 here): at most 1 element in
    1,000 of the state (over all leaves) may differ by such a step, the
    rest within the tight tolerance, and the norm of the compressed
    grads within rtol 1e-3 (a flipped code moves it by up to step *
    absmax / norm, ≈1e-3 here; one run measured 1.3e-5)."""
    j, t, metrics, tcfg = _both_steps("qwen2.5-3b", mb=2, **kw)
    _assert_steps_close(j, t, metrics, tcfg,
                        norm_rtol=1e-3 if kw.get("grad_compress_bits")
                        else LOSS_TOL["rtol"])
    states = [(t[1].inner, j[1].inner)]
    if kw.get("grad_compress_bits"):
        states.append((t[2], j[2]))
    for ts, js in states:
        n_off = n = 0
        for x, y in zip(tree_leaves(ts), jax.tree.leaves(js)):
            x, y = x.numpy(), np.asarray(y)
            n_off += int((np.abs(x - y) > 2e-6 + 1e-4 * np.abs(y)).sum())
            n += x.size
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-2)
        assert n_off <= (1e-3 * n if kw.get("grad_compress_bits") else 0)


def test_microbatches_give_the_same_step():
    """1, 2 and 4 microbatches of one batch: float32 accumulation of the
    token-mean losses of equal microbatches equals the whole batch."""
    out = {}
    for mb in (1, 2, 4):
        _, _, tcfg, tp = _models("qwen2.5-3b")
        ttc = TrainConfig(**TRAIN_KW, microbatches=mb)
        step = make_train_step(tcfg, ttc)
        b = DataPipeline(tcfg, batch=B, seq_len=S, seed=5).batch_at(0)
        tp, _, _, m = step(tp, make_optimizer("adamw")[0](tp), {}, b)
        out[mb] = (m, tp)
    for mb in (2, 4):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(out[mb][0][k]),
                                       float(out[1][0][k]), rtol=1e-6)
        for x, y in zip(tree_leaves(out[mb][1]), tree_leaves(out[1][1])):
            torch.testing.assert_close(x, y, rtol=0, atol=2 * TRAIN_KW["lr"])


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        tt_, tn = clip_by_global_norm(tree_map(torch.from_numpy, tree),
                                      max_norm)
        jt_, jn = j_clip(jax.tree.map(jnp.asarray, tree), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees_close(tt_, jt_, rtol=1e-6, atol=0)


def test_global_norm_keeps_small_terms_of_a_large_leaf():
    """A few large gradients and 4 M small ones: the norm within 1e-6 of
    float64's.  (On the CPU ``torch.linalg.vector_norm`` loses the small
    terms: 0.1% low here, 0.3% on qwen2.5-3b's embedding gradient, which
    a card-against-CPU train step caught.)"""
    g = torch.randn(1 << 22, generator=torch.Generator().manual_seed(9))
    g = g * 1e-3
    g[:100] *= 1000
    want = float(torch.linalg.vector_norm(g.double()))
    got = float(ttrainer._global_norm({"g": g, "h": {"k": g[:7]}}))
    want = (want ** 2 + float(g[:7].double().square().sum())) ** 0.5
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_step_updates_in_place_and_takes_numpy_batches():
    _, _, tcfg, tp = _models("qwen2.5-3b")
    ptrs = [p.data_ptr() for p in tree_leaves(tp)]
    step = make_train_step(tcfg, TrainConfig(**TRAIN_KW), donate=False)
    b = DataPipeline(tcfg, batch=2, seq_len=8).batch_at(0)
    new, opt, ef, m = step(tp, make_optimizer("adamw")[0](tp), {}, b)
    assert [p.data_ptr() for p in tree_leaves(new)] == ptrs
    assert ef == {} and set(m) == {"loss", "grad_norm", "lr"}
    assert not any(p.requires_grad for p in tree_leaves(new))


# --------------------------------------------------------------- trainer
def _trainer(tmp_path, drill, arch="qwen2.5-3b", steps_every=2):
    _, _, tcfg, tp = _models(arch)
    return Trainer(
        tcfg, TrainConfig(**TRAIN_KW, microbatches=2), unstack_layers(tp),
        DataPipeline(tcfg, batch=B, seq_len=S, seed=7),
        ckpt_manager=CheckpointManager(str(tmp_path), keep=2),
        ckpt_every=steps_every, straggler_monitor=StragglerMonitor(),
        failure_injector=FailureInjector(schedule={3: 0}) if drill
        else None)


def test_trainer_restart_drill(tmp_path):
    """Checkpoints every 2 steps, a node failure injected at step 3: the
    trainer restores step 2 (params, optimizer state, the pipeline's
    position) and ends with the uninterrupted run's losses and params."""
    plain = _trainer(tmp_path / "plain", drill=False)
    want = plain.run(5)["loss"]
    drill = _trainer(tmp_path / "drill", drill=True)
    got = drill.run(5)["loss"]
    assert drill.restarts == 1 and len(got) == 6
    np.testing.assert_allclose(got[:3] + got[4:], want, rtol=0, atol=1e-6)
    assert got[3] == got[2]
    for x, y in zip(tree_leaves(drill.params), tree_leaves(plain.params)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    # the restore put the stream at the checkpoint's step, as in JAX
    assert drill.pipeline.state.step == 2
    assert isinstance(drill.opt_state, OptState)
    assert isinstance(drill.params["layers"], dict)


def test_opt_state_leaf_paths_match_jax():
    """A named tuple's leaves are ``.<field>``, as JAX names them."""
    cfg, jp, _, tp = _models("qwen2.5-3b")
    jtree = {"params": jp, "opt": j_adamw_init(jp), "ef": {}}
    ttree = {"params": tp, "opt": make_optimizer("adamw")[0](tp), "ef": {}}
    paths = tckpt._leaf_paths(ttree)[0]
    assert paths == jckpt._leaf_paths(jtree)[0]
    assert "opt/.step" in paths and "opt/.inner/m/embed" in paths


def _jax_trainer(ckpt_dir, cfg, jp):
    return JTrainer(cfg, JTrainConfig(**TRAIN_KW, microbatches=2), jp,
                    JPipeline(cfg, batch=B, seq_len=S, seed=7),
                    ckpt_manager=JManager(str(ckpt_dir), keep=3),
                    ckpt_every=2)


def test_training_checkpoint_jax_to_port_to_jax(tmp_path):
    """JAX's Trainer checkpoints step 2; the port's resumes from it (params
    and optimizer state byte-equal, the pipeline at step 2), runs to step
    4 with JAX's losses, and checkpoints; JAX's Trainer resumes from the
    port's checkpoint with the port's state."""
    cfg, jp, tcfg, tp = _models("qwen2.5-3b")
    ref = _jax_trainer(tmp_path / "ref", cfg, jp)
    want = ref.run(4)["loss"]
    jtr = _jax_trainer(tmp_path / "ckpt", cfg, jp)
    jtr.run(2)
    port = Trainer(tcfg, TrainConfig(**TRAIN_KW, microbatches=2), tp,
                   DataPipeline(tcfg, batch=B, seq_len=S, seed=7),
                   ckpt_manager=CheckpointManager(str(tmp_path / "ckpt"),
                                                  keep=3), ckpt_every=2)
    assert port.maybe_resume() == 2
    assert port.pipeline.state.step == 2 and int(port.opt_state.step) == 2
    _assert_trees_close(port.params, jtr.params, rtol=0, atol=0)
    _assert_trees_close(port.opt_state.inner, jtr.opt_state.inner, rtol=0,
                        atol=0)
    got = port.run(4)["loss"]
    np.testing.assert_allclose(got, want[2:], **LOSS_TOL)
    back = _jax_trainer(tmp_path / "ckpt", cfg, jp)
    assert back.maybe_resume() == 4
    _assert_trees_close(port.params, back.params, rtol=0, atol=0)
    _assert_trees_close(port.opt_state.inner, back.opt_state.inner, rtol=0,
                        atol=0)
    assert int(back.opt_state.step) == 4


def test_stack_and_unstack_layers():
    _, _, tcfg, tp = _models("zamba2-7b")
    views = unstack_layers(tp)
    assert len(views["layers"]) == tcfg.n_layers
    leaf = views["layers"][1]["ssm"]["in_proj"]["w"]
    assert leaf.data_ptr() != tp["layers"]["ssm"]["in_proj"]["w"].data_ptr()
    assert leaf.untyped_storage().data_ptr() == (
        tp["layers"]["ssm"]["in_proj"]["w"].untyped_storage().data_ptr())
    again = stack_layers(views)
    for x, y in zip(tree_leaves(again), tree_leaves(tp)):
        assert torch.equal(x, y)
    assert again["shared_attn"] is tp["shared_attn"]


def test_train_lm_driver_on_the_cpu(tmp_path, capsys):
    from repro_torch.train import train_lm

    hist = train_lm.main(["--device", "cpu", "--steps", "4", "--batch",
                          "4", "--seq", "16", "--width", "32", "--layers",
                          "2", "--ckpt-dir", str(tmp_path),
                          "--inject-failure", "2"])
    out = capsys.readouterr().out
    assert "trained 6 steps (restarts=1)" in out
    assert all(np.isfinite(hist))


def test_straggler_monitor_matches_jax():
    rng = np.random.default_rng(8)
    t, j = StragglerMonitor(), JStraggler()
    for step in range(40):
        times = {h: float(rng.uniform(0.9, 1.1)) for h in range(4)}
        if step > 10:
            times[2] *= 3.0
        new_t, new_j = t.observe(step, times), j.observe(step, times)
        assert [dataclasses.astuple(e) for e in new_t] == [
            dataclasses.astuple(e) for e in new_j]
    assert [(e.step, e.host, e.action) for e in t.events] == [
        (e.step, e.host, e.action) for e in j.events]
    assert t.chronic_hosts() == j.chronic_hosts() == [2]


# ------------------------------------------------- kernels and autograd
@pytest.mark.parametrize("name", GRAD_KERNELS)
def test_kernel_wrappers_refuse_grad_inputs_first(name):
    """Off the CPU (meta tensors here) a wrapper goes to its CUDA launcher,
    which refuses an input that requires grad under grad mode before any
    other check; on CPU tensors the plain version runs and records
    autograd history."""
    fn, args, kw, i = grad_cases(torch.device("meta"))[name]
    args[i].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args, **kw)
    fn, args, kw, i = grad_cases(torch.device("cpu"))[name]
    args[i].requires_grad_(True)
    out = fn(*args, **kw)
    assert (out[0] if isinstance(out, tuple) else out).requires_grad
