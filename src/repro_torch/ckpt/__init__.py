"""Sharded, integrity-checked checkpoints in the JAX package's on-disk
format (``repro.ckpt``): a checkpoint written by one package loads in the
other."""

from repro_torch.ckpt.checkpoint import (
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.ckpt.manager import CheckpointManager

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointManager"]
