"""mistral-large-123b [dense] — 88L, d_model=12288, 96H (GQA kv=8),
d_ff=28672, vocab=32768, full attention.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""

import dataclasses

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="mistral-large-smoke",
        n_layers=3,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
    )


register_arch("mistral-large-123b", CONFIG, reduced)
