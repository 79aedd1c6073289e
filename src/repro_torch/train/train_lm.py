"""Training driver with the full loop: deterministic sharded data, AdamW +
cosine schedule, gradient accumulation, checkpointing with auto-resume, a
simulated node failure mid-run, and straggler monitoring — the port's
counterpart of the JAX package's ``examples/train_lm.py``, with the same
flags and ``--device``.

Default is a ~5M-param qwen2.5-family model; pass --arch/--width/--layers
to grow it.  On the card (the default device)::

    PYTHONPATH=src python -m repro_torch.train.train_lm --steps 60

and on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.config import TrainConfig, get_reduced
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.ft import FailureInjector, StragglerMonitor
from repro_torch.models import init_params
from repro_torch.train import Trainer
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm"))
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="step at which to simulate a node failure")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_reduced(args.arch),
        dtype="float32",
        d_model=args.width,
        n_layers=args.layers,
        d_ff=args.width * 3,
        vocab_size=4096,
    )
    params = init_params(cfg, torch.Generator(device).manual_seed(0))
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {cfg.name} {n:,} params on {device}")

    tcfg = TrainConfig(lr=3e-4, total_steps=args.steps, warmup_steps=10,
                       microbatches=2)
    pipe = DataPipeline(cfg, batch=args.batch, seq_len=args.seq, seed=0)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    injector = None
    if args.inject_failure >= 0:
        injector = FailureInjector(schedule={args.inject_failure: 0})

    tr = Trainer(
        cfg, tcfg, params, pipe,
        ckpt_manager=CheckpointManager(args.ckpt_dir, keep=2),
        ckpt_every=20,
        straggler_monitor=StragglerMonitor(),
        failure_injector=injector,
    )
    hist = tr.run(args.steps)["loss"]
    print(f"trained {len(hist)} steps (restarts={tr.restarts}): "
          f"loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    stragglers = tr.straggler.chronic_hosts()
    print(f"chronic stragglers: {stragglers or 'none'}")
    print(f"checkpoints under {args.ckpt_dir}: resume by re-running")
    return hist


if __name__ == "__main__":
    main()
