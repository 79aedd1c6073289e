"""The GEMV engine's front door: :class:`PackedLinear`, the backend
registry (``reference`` / ``bit_serial`` / ``cuda``, each with its grouped
form for stacked experts, and ``sharded``, which wraps one of them on a
mesh of ranks) and
:class:`EnginePlan`, resolved once from an ``EngineConfig`` and a device.

Typical use::

    plan = resolve_plan(serve_cfg.engine, device="cuda")
    lin = pack_linear(w, plan.bits)
    y = plan.apply(lin, x)
"""

from repro_torch.engine.backends import (
    ATTN_BACKENDS,
    get_backend,
    get_grouped_backend,
    register_backend,
    register_grouped_backend,
    resolve_attn_backend,
    resolve_backend_name,
)
from repro_torch.engine.packed import (
    PackedLinear,
    as_packed,
    is_packed,
    pack_linear,
    partition_kind,
    validate_bits,
)
from repro_torch.engine.plan import EnginePlan, plan_for_bits, resolve_plan
from repro_torch.engine import sharded  # noqa: F401  registers "sharded"

__all__ = [
    "ATTN_BACKENDS",
    "EnginePlan",
    "PackedLinear",
    "as_packed",
    "get_backend",
    "get_grouped_backend",
    "is_packed",
    "pack_linear",
    "partition_kind",
    "plan_for_bits",
    "register_backend",
    "register_grouped_backend",
    "resolve_attn_backend",
    "resolve_backend_name",
    "resolve_plan",
    "validate_bits",
]
