from repro_torch.models.transformer import (
    decode_step,
    decode_step_paged,
    forward,
    init_cache,
    init_params,
    prefill,
    prefill_chunk,
    quantize_params,
)

__all__ = [
    "decode_step",
    "decode_step_paged",
    "forward",
    "init_cache",
    "init_params",
    "prefill",
    "prefill_chunk",
    "quantize_params",
]
