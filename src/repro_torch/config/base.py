"""Configuration dataclasses of the PyTorch port.

The port keeps its own copy of the three dataclasses its serving path
reads — :class:`ModelConfig`, :class:`EngineConfig` and
:class:`ServeConfig` — with every field and default of the JAX package's
``repro.config.base``, so the same keyword arguments construct both.
Options whose machinery is not ported yet are refused where they are
resolved (``EngineConfig(sharded=True)`` here, the serve options in
``repro_torch.serve.engine``), never ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-family model definition.

    Block kinds are derived from ``family`` (dense / vlm / audio: attention
    + dense MLP every layer; moe; ssm; hybrid).  The port runs the dense
    and ssm families; the other fields are kept so configs stay
    interchangeable.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention details -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention
    global_every: int = 0            # gemma3: every Nth layer is global
    attn_logit_softcap: float = 0.0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # --- hybrid (zamba2) ------------------------------------------------------
    attn_every: int = 0

    # --- modality frontends ---------------------------------------------------
    frontend: str = ""               # "" | "vision" | "audio"
    n_codebooks: int = 1
    img_tokens: int = 0

    # --- mlp style --------------------------------------------------------------
    mlp_gated: bool = True           # SwiGLU (3 mats); False = GELU MLP

    # --- numerics --------------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_global_layer(self, i: int) -> bool:
        """Gemma3-style local:global pattern: layer i uses global attention."""
        if self.sliding_window == 0:
            return True
        if self.global_every == 0:
            return False
        return (i % self.global_every) == (self.global_every - 1)


@dataclass(frozen=True)
class EngineConfig:
    """The IMAGine GEMV engine: ``weight_bits`` (0 = dense weights, else
    2/4/8-bit bit-plane packed), ``radix`` bits retired per bit-serial
    pass, ``kv_bits`` (0 or int8 KV pages), and the ``backend`` /
    ``attn_backend`` registry names ("auto" resolves by device when the
    config becomes an ``EnginePlan``).  ``tile_m``/``tile_k`` are the JAX
    kernel's tile sizes, kept for parity of construction; the CUDA kernel
    picks its own tiles.  ``sharded`` / ``psum_bits`` belong to the
    multi-device backend, which is not ported yet."""

    weight_bits: int = 0
    radix: int = 1
    kv_bits: int = 0
    act_dtype: str = "bfloat16"
    backend: str = "auto"
    attn_backend: str = "auto"
    tile_m: int = 256
    tile_k: int = 512
    sharded: bool = False
    psum_bits: int = 0

    def __post_init__(self):
        if self.weight_bits not in (0, 2, 4, 8):
            raise ValueError(
                f"weight_bits must be 0/2/4/8, got {self.weight_bits}")
        if self.radix not in (1, 2, 4, 8):
            raise ValueError(f"radix must be 1/2/4/8, got {self.radix}")
        if self.kv_bits not in (0, 8):
            raise ValueError(f"kv_bits must be 0/8, got {self.kv_bits}")
        if self.psum_bits not in (0, 4, 8):
            raise ValueError(f"psum_bits must be 0/4/8, got {self.psum_bits}")
        if not isinstance(self.backend, str) or not self.backend:
            raise ValueError(
                f"backend must be a backend name, got {self.backend!r}")
        if not isinstance(self.attn_backend, str) or not self.attn_backend:
            raise ValueError(f"attn_backend must be a backend name, got "
                             f"{self.attn_backend!r}")
        if self.sharded:
            raise NotImplementedError(
                "EngineConfig(sharded=True): the mesh-sharded backend is not "
                "ported yet")

    @property
    def enabled(self) -> bool:
        return self.weight_bits > 0


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs, field for field those of the JAX package.  The port
    serves ``mode="paged"`` with FCFS scheduling; ``prefix_cache``,
    ``sched="budget"``, ``audit`` and the retry budget are refused by
    ``repro_torch.serve.ServeEngine`` until they are ported."""

    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0
    engine: EngineConfig = field(default_factory=EngineConfig)
    mode: str = "auto"                # auto | paged | slots
    page_size: int = 16
    n_pages: int = 0                  # 0 = full capacity (never preempts)
    prefill_chunk: int = 32
    prefix_cache: bool = False
    sched: str = "fcfs"               # fcfs | budget
    step_tokens: int = 0
    max_queue: int = 0                # 0 = unbounded admission queue
    audit: int = 0
    max_request_retries: int = 1
    retry_reset_steps: int = 0

    def __post_init__(self):
        if self.mode not in ("auto", "paged", "slots"):
            raise ValueError(f"mode must be auto/paged/slots, got {self.mode}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.sched not in ("fcfs", "budget"):
            raise ValueError(f"sched must be fcfs/budget, got {self.sched}")
        if self.step_tokens < 0:
            raise ValueError(
                f"step_tokens must be >= 0, got {self.step_tokens}")
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")
        if self.audit not in (0, 1, 2):
            raise ValueError(f"audit must be 0/1/2, got {self.audit}")
        if self.max_request_retries < 0:
            raise ValueError(
                f"max_request_retries must be >= 0, "
                f"got {self.max_request_retries}")
        if self.retry_reset_steps < 0:
            raise ValueError(
                f"retry_reset_steps must be >= 0, "
                f"got {self.retry_reset_steps}")
