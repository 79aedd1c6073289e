"""qwen2.5-3b [dense] — 36L, d_model=2048, 16H (GQA kv=2), d_ff=11008,
vocab=151936, GQA with QKV bias, tied embeddings.
"""

import dataclasses

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen2.5-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )


register_arch("qwen2.5-3b", CONFIG, reduced)
