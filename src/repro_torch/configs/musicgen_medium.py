"""musicgen-medium [audio] — 48L, d_model=1536, 24H (kv=24, MHA), d_ff=6144,
vocab=2048 per codebook, decoder-only over EnCodec tokens with 4 codebooks
(delay pattern).  The EnCodec frontend is a STUB per the assignment:
``input_specs`` provides the 4 codebook token streams directly.
[arXiv:2306.05284; hf]
"""

import dataclasses

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio",
    n_codebooks=4,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="musicgen-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=64,
        n_codebooks=2,
    )


register_arch("musicgen-medium", CONFIG, reduced)
