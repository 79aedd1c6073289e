"""llava-next-mistral-7b [vlm] — 32L, d_model=4096, 32H (GQA kv=8),
d_ff=14336, vocab=32000, anyres tiling.  The vision frontend is a STUB per
the assignment: ``input_specs`` provides precomputed patch embeddings
(anyres -> up to 2880 image tokens) which are prepended to the text stream.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

import dataclasses

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    frontend="vision",
    img_tokens=2880,  # anyres: 5 tiles x 576 patch tokens
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="llava-next-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        img_tokens=16,
    )


register_arch("llava-next-mistral-7b", CONFIG, reduced)
