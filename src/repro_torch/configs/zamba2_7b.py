"""zamba2-7b [hybrid] — 81L, d_model=3584, 32H (GQA kv=32, i.e. MHA in the
shared block), d_ff=14336, vocab=32000, ssm_state=64.  Mamba2 backbone with a
*shared-weight* attention block applied periodically (every 6 layers here).
[arXiv:2411.15242; unverified]
"""

import dataclasses

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    attn_every=6,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="zamba2-smoke",
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=16,
        attn_every=3,
    )


register_arch("zamba2-7b", CONFIG, reduced)
