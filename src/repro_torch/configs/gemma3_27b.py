"""gemma3-27b [dense] — 62L, d_model=5376, 32H (GQA kv=16), d_ff=21504,
vocab=262144, 5:1 local:global sliding-window attention (window 1024),
128k context.  [hf:google/gemma-3-1b-pt family; unverified]
"""

import dataclasses

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    sliding_window=1024,
    global_every=6,           # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="gemma3-smoke",
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=8,
        global_every=3,
    )


register_arch("gemma3-27b", CONFIG, reduced)
