"""qwen3-moe-235b-a22b [moe] — 94L, d_model=4096, 64H (GQA kv=4),
expert d_ff=1536, vocab=151936, MoE 128 experts top-8, no shared expert.
[hf:Qwen/Qwen3-30B-A3B family; hf]
"""

import dataclasses

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,            # = expert width (no shared expert)
    vocab_size=151_936,
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    n_shared_experts=0,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen3-moe-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        n_experts=8,
        top_k=2,
        moe_d_ff=96,
    )


register_arch("qwen3-moe-235b-a22b", CONFIG, reduced)
