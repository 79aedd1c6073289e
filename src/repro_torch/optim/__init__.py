"""Optimizers, the LR schedule and error-feedback gradient compression,
the JAX package's ``repro.optim`` over nested dicts of tensors."""

from repro_torch.optim.optimizers import (
    LeafShards,
    OptState,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    make_optimizer,
    sgd_init,
    sgd_update,
)
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.optim.grad_compress import (
    compress_decompress,
    ef_state_init,
    error_feedback_compress,
)

__all__ = [
    "OptState",
    "adamw_init",
    "adamw_update",
    "adafactor_init",
    "adafactor_update",
    "sgd_init",
    "sgd_update",
    "make_optimizer",
    "cosine_warmup",
    "compress_decompress",
    "ef_state_init",
    "error_feedback_compress",
]
