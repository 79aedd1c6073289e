"""starcoder2-15b [dense] — 40L, d_model=6144, 48H (GQA kv=4), d_ff=24576,
vocab=49152, GQA + RoPE.  [arXiv:2402.19173; hf]
"""

import dataclasses

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=100_000.0,
    mlp_gated=False,  # starcoder2 uses a plain GELU MLP (c_fc/c_proj)
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="starcoder2-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
    )


register_arch("starcoder2-15b", CONFIG, reduced)
