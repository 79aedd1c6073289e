"""llama4-scout-17b-a16e [moe] — 48L, d_model=5120, 40H (GQA kv=8),
expert d_ff=8192, vocab=202048, MoE 16 experts top-1 + 1 shared expert,
early fusion (text backbone here; modality frontend stubbed).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""

import dataclasses

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,            # shared-expert width
    vocab_size=202_048,
    n_experts=16,
    top_k=1,
    moe_d_ff=8192,
    n_shared_experts=1,
    rope_theta=500_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="llama4-scout-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_experts=4,
        top_k=1,
        moe_d_ff=128,
        n_shared_experts=1,
    )


register_arch("llama4-scout-17b-a16e", CONFIG, reduced)
