"""Training loop: the train-step factory and a :class:`Trainer` that wires
the data pipeline, checkpoint manager, failure injection/restart and
straggler monitoring together, the JAX package's ``repro.train.trainer``.

``make_train_step`` builds the step: microbatched gradient accumulation in
float32, optional int8 error-feedback gradient compression, global-norm
clipping, the cosine-warmup LR and the chosen optimizer, in that order.

The training state — params, optimizer state, error-feedback buffer —
lives in the JAX package's layout (:func:`repro_torch.weights.stack_layers`:
each leaf under ``"layers"`` stacks the layers on axis 0), so the
optimizer and the compression see JAX's leaves (Adafactor factors, and
the compression scales, a stacked leaf as a whole) and a checkpoint names
its leaves as JAX's does: one written by either package resumes in the
other.  The forward pass gets per-layer views of the stacked leaves.

The loss runs ``forward(..., attn_backend="gather")``: the plain attention
and SSD paths, which is what the JAX package trains on (its Pallas flash
kernel is off by default and none of its kernels has a backward pass).
The CUDA kernels refuse inputs that require grad, and no backward kernel
is written.  Linears are float weights (``torch.matmul``), as in JAX.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, TrainConfig
from repro_torch.models.transformer import chunked_ce, forward
from repro_torch.optim import (
    cosine_warmup,
    ef_state_init,
    error_feedback_compress,
    make_optimizer,
)
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import stack_layers

Tree = Any
F32 = torch.float32


def _global_norm(tree) -> torch.Tensor:
    # a sum of squares, as JAX's: on the CPU ``torch.linalg.vector_norm``
    # of a 311 M-element float32 leaf (qwen2.5-3b's embedding) comes out
    # 0.1-0.3% low, where ``torch.sum`` sums in a cascade
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(F32)))
                          for leaf in tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled to global norm <= max_norm, in float32; the norm)``."""
    norm = _global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(F32) * scale, tree), norm


def _as_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Tensors on ``device`` (a numpy array copied: a memmap source's
    batch is a read-only view of the file)."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                ).to(device) for k, v in batch.items()}


def _grad_pieces(params: Tree, acc: Tree):
    """The forward's parameters as tensors that record gradients — one
    per leaf, and one per layer of a stacked leaf, each a view of the
    stacked storage — with the accumulator slice each one's gradient
    adds into."""
    pieces, slots = [], []

    def piece(p, a):
        t = p.detach().requires_grad_(True)
        pieces.append(t)
        slots.append(a)
        return t

    tree = {k: tree_map(piece, v, acc[k])
            for k, v in params.items() if k != "layers"}
    n = tree_leaves(params["layers"])[0].shape[0]
    tree["layers"] = [
        tree_map(lambda p, a, i=i: piece(p[i], a[i]), params["layers"],
                 acc["layers"]) for i in range(n)]
    return tree, pieces, slots


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    donate: bool = True) -> Callable:
    """Returns ``step(params, opt_state, ef_state, batch) -> (params,
    opt_state, ef_state, metrics)``, params and states in the stacked
    layout, ``batch`` numpy arrays or tensors (moved to the params'
    device).  ``metrics``: ``loss``, ``grad_norm``, ``lr`` as 0-d float32
    tensors.

    The step updates the params and the optimizer state in place and
    returns them, as JAX's donated step reuses their buffers; ``donate``
    is accepted for JAX's signature and changes nothing.  ``ef_state`` is
    the error-feedback buffer when gradient compression is on (an empty
    dict otherwise).
    """
    del donate
    _, update_fn = make_optimizer(tcfg.optimizer)

    def loss_of(params, batch):
        hidden, aux = forward(params, batch, cfg, remat=tcfg.remat,
                              return_hidden=True, attn_backend="gather")
        return chunked_ce(params, hidden, batch["labels"], cfg, aux=aux)

    def accumulate(acc, params, batch) -> torch.Tensor:
        tree, pieces, slots = _grad_pieces(params, acc)
        with torch.enable_grad():
            loss = loss_of(tree, batch)
            grads = torch.autograd.grad(loss, pieces, allow_unused=True)
        with torch.no_grad():
            for a, g in zip(slots, grads):
                if g is not None:
                    a.add_(g)
        return loss.detach()

    def step(params, opt_state, ef_state, batch):
        device = tree_leaves(params)[0].device
        batch = _as_batch(batch, device)
        mb = tcfg.microbatches
        # float32 from the start: for mb == 1 it holds the grads exactly
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                             device=p.device), params)
        if mb > 1:
            micros = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                      for k, v in batch.items()}
            loss = torch.zeros((), dtype=F32, device=device)
            for i in range(mb):
                loss = loss + accumulate(
                    acc, params, {k: v[i] for k, v in micros.items()})
            loss = loss / mb
            for a in tree_leaves(acc):
                a.div_(mb)
        else:
            loss = accumulate(acc, params, batch)

        with torch.no_grad():
            if tcfg.grad_compress_bits:
                acc, ef_state = error_feedback_compress(
                    acc, ef_state, tcfg.grad_compress_bits)
            gnorm = _global_norm(acc)
            scale = _clip_scale(gnorm, tcfg.grad_clip)
            for a in tree_leaves(acc):
                a.mul_(scale)
            lr = cosine_warmup(opt_state.step, tcfg.lr, tcfg.warmup_steps,
                               tcfg.total_steps)
            params, opt_state = update_fn(acc, opt_state, params, tcfg, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, ef_state, metrics

    return step


class Trainer:
    """Step-loop driver with checkpoint/restart and straggler hooks.

    ``params`` in either layout (the port's per-layer list, from
    ``init_params``, is stacked here); ``self.params`` holds them stacked.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        params,
        pipeline,
        ckpt_manager=None,
        ckpt_every: int = 50,
        straggler_monitor=None,
        failure_injector=None,
    ):
        self.cfg, self.tcfg = cfg, tcfg
        if isinstance(params["layers"], list):
            params = stack_layers(params)
        self.params = params
        init_fn, _ = make_optimizer(tcfg.optimizer)
        self.opt_state = init_fn(params)
        self.ef_state = (ef_state_init(params) if tcfg.grad_compress_bits
                         else {})
        self.pipeline = pipeline
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.straggler = straggler_monitor
        self.injector = failure_injector
        self.step_fn = make_train_step(cfg, tcfg, donate=False)
        self.history: list = []
        self.restarts = 0

    def _state(self):
        return {"params": self.params, "opt": self.opt_state,
                "ef": self.ef_state}

    # -------------------------------------------------------------- resume
    def maybe_resume(self) -> int:
        if self.ckpt is None:
            return 0
        step, tree, extra = self.ckpt.restore_latest(self._state())
        if step is None:
            return 0
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.ef_state = tree["ef"]
        self.pipeline.state.step = int(extra.get("data_step", step))
        return step

    # ----------------------------------------------------------------- run
    def run(self, total_steps: int) -> Dict[str, list]:
        from repro_torch.ft.failures import run_with_restarts

        start = self.maybe_resume()

        def do_step(step: int):
            t0 = time.perf_counter()
            self.params, self.opt_state, self.ef_state, metrics = (
                self.step_fn(self.params, self.opt_state, self.ef_state,
                             self.pipeline.batch_at(step)))
            loss = float(metrics["loss"])
            self.history.append(loss)
            dt = time.perf_counter() - t0
            if self.straggler is not None:
                self.straggler.observe(step, {0: dt})
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, self._state(),
                               extra={"data_step": step + 1})

        def restore() -> int:
            step = self.maybe_resume()
            self.restarts += 1
            return step

        run_with_restarts(
            do_step, start_step=start, total_steps=total_steps,
            restore_fn=restore, injector=self.injector)
        if self.ckpt is not None:
            self.ckpt.wait()
        return {"loss": self.history}
