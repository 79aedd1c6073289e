"""Shared test fixtures.

NOTE: no XLA device-count flags here — smoke tests and benches must see the
real single CPU device; only launch/dryrun.py forces 512 host devices.
"""

import dataclasses

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: runs a hand-written CUDA kernel of repro_torch; skips on a "
        "host without a CUDA device")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def reduced_f32(arch: str, **overrides):
    """Reduced same-family config in float32 for CPU numerics."""
    from repro.config import get_reduced

    return dataclasses.replace(get_reduced(arch), dtype="float32", **overrides)


ALL_ARCHS = [
    "gemma3-27b",
    "mistral-large-123b",
    "starcoder2-15b",
    "qwen2.5-3b",
    "llava-next-mistral-7b",
    "mamba2-130m",
    "zamba2-7b",
    "musicgen-medium",
    "llama4-scout-17b-a16e",
    "qwen3-moe-235b-a22b",
]


def make_batch(cfg, rng, batch=2, seq=16):
    """Family-appropriate batch dict (tokens/labels [+ modality stubs])."""
    import jax

    ks = jax.random.split(rng, 3)
    if cfg.family == "audio":
        toks = jax.random.randint(
            ks[0], (batch, seq + 1, cfg.n_codebooks), 0, cfg.vocab_size)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    else:
        toks = jax.random.randint(ks[0], (batch, seq + 1), 0, cfg.vocab_size)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["img_embeds"] = jax.random.normal(
            ks[1], (batch, cfg.img_tokens, cfg.d_model))
    return out
