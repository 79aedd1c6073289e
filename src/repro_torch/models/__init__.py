from repro_torch.models.transformer import (
    decode_step_paged,
    init_params,
    prefill_chunk,
    quantize_params,
)

__all__ = [
    "decode_step_paged",
    "init_params",
    "prefill_chunk",
    "quantize_params",
]
