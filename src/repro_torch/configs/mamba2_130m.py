"""mamba2-130m [ssm] — 24L, d_model=768, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060; unverified]
"""

import dataclasses

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="mamba2-smoke",
        n_layers=3,
        d_model=64,
        vocab_size=256,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=16,
    )


register_arch("mamba2-130m", CONFIG, reduced)
