"""Configuration dataclasses of the PyTorch port.

The port keeps its own copy of the JAX package's ``repro.config.base``
dataclasses — :class:`ModelConfig`, :class:`EngineConfig`,
:class:`ServeConfig`, the training loop's :class:`TrainConfig` and the
run cell's :class:`ShapeConfig`, :class:`MeshConfig` and
:class:`RunConfig` — with every field and default, so the same keyword
arguments construct both.
Options whose machinery is not ported yet are refused where they are
resolved (the serve options in ``repro_torch.serve.engine``), never
ignored.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Tuple

# the six families the port runs; those whose every layer keeps attention
# K/V, served paged (ssm / hybrid keep O(1) recurrent state and stay on
# the fixed-slot engine), as the JAX package's PAGED_FAMILIES
FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")
PAGED_FAMILIES = ("dense", "vlm", "audio", "moe")


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-family model definition.

    Block kinds are derived from ``family`` (dense / vlm / audio: attention
    + dense MLP every layer; moe; ssm; hybrid: ssm layers with one shared
    attention block applied every ``attn_every`` layers).  The port runs
    all six families; every field is kept so configs stay interchangeable.
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

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """May this arch run the 500k-token long-context decode cell?

        True for SSM / hybrid archs (O(1) state) and for mostly-local
        attention stacks (gemma3's 5:1 local:global with a 1k window).
        """
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0 and self.global_every > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length ``n_layers``.

        dense archs -> ("attn",) * L             (window/global split is a flag)
        moe         -> ("moe",) * L
        ssm         -> ("ssm",) * L
        hybrid      -> ssm blocks, with a shared "attn" applied every
                        ``attn_every`` layers *in addition to* the ssm block.
        """
        if self.family in ("dense", "vlm", "audio"):
            return ("attn",) * self.n_layers
        if self.family == "moe":
            return ("moe",) * self.n_layers
        if self.family in ("ssm", "hybrid"):
            return ("ssm",) * self.n_layers
        raise ValueError(f"unknown family {self.family!r}")

    def is_global_layer(self, i: int) -> bool:
        """Gemma3-style local:global pattern: layer i uses global attention."""
        if self.sliding_window == 0:
            return True
        if self.global_every == 0:
            return False
        return (i % self.global_every) == (self.global_every - 1)

    # --- parameter accounting (used by roofline MODEL_FLOPS and docs) ---------
    def param_count(self) -> int:
        """Total parameter count N (embedding included once)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        per_layer = 0
        attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        if self.qkv_bias:
            attn += (n_q + 2 * n_kv) * hd
        mlp_mats = 3 if self.mlp_gated else 2
        mlp_dense = mlp_mats * d * self.d_ff
        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn + mlp_dense + 2 * d  # 2 RMSNorm scales
        elif self.family == "moe":
            routed = self.n_experts * 3 * d * self.moe_d_ff
            shared = self.n_shared_experts * 3 * d * self.d_ff
            router = d * self.n_experts
            per_layer = attn + routed + shared + router + 2 * d
        elif self.family in ("ssm", "hybrid"):
            di, st, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            in_proj = d * (2 * di + 2 * st + nh)  # z, x, B, C, dt
            conv = (di + 2 * st) * self.conv_width
            out_proj = di * d
            ssm_misc = 2 * nh + di  # A_log, dt_bias, norm scale on gate
            per_layer = in_proj + conv + out_proj + ssm_misc + 2 * d
        total = self.n_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            # one shared-weight attention+MLP block
            total += attn + mlp_dense + 2 * d
        emb = self.vocab_size * d * self.n_codebooks
        head = 0 if self.tie_embeddings else self.vocab_size * d * self.n_codebooks
        total += emb + head + d  # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE uses top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        routed_all = self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        routed_active = self.n_layers * self.top_k * 3 * d * self.moe_d_ff
        return int(self.param_count() - routed_all + routed_active)


@dataclass(frozen=True)
class EngineConfig:
    """The IMAGine GEMV engine: ``weight_bits`` (0 = dense weights, else
    2/4/8-bit bit-plane packed), ``radix`` bits retired per bit-serial
    pass, ``kv_bits`` (0 or int8 KV pages), and the ``backend`` /
    ``attn_backend`` registry names ("auto" resolves by device when the
    config becomes an ``EnginePlan``).  ``tile_m``/``tile_k`` are the JAX
    kernel's tile sizes, kept for parity of construction; the CUDA kernel
    picks its own tiles.  ``sharded`` wraps ``backend`` in the mesh's
    ``sharded`` backend (``engine/sharded.py``); ``psum_bits`` is the
    precision of its row-parallel sums (0 exact, 4/8 compressed)."""

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

    @property
    def enabled(self) -> bool:
        return self.weight_bits > 0


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs, field for field those of the JAX package.  The retry
    budget (``max_request_retries``, ``retry_reset_steps``) bounds each
    request's recompute-style retries after a step fault or non-finite
    logits in paged mode; past it the request is quarantined
    (``finish_reason="error"``)."""

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


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: str        # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class MeshConfig:
    """Mesh geometry of the JAX package's production cells (a 16x16 pod,
    or 2x16x16 with a ``pod`` axis of data or pipeline parallelism).  The
    port runs on one card; the mesh is kept for parity of construction."""

    multi_pod: bool = False
    pod_axis_mode: str = "data"  # "data" | "pipeline"

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_devices(self) -> int:
        return int(math.prod(self.shape))

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Mesh axes over which the batch is sharded."""
        if self.multi_pod and self.pod_axis_mode == "data":
            return ("pod", "data")
        return ("data",)


@dataclass(frozen=True)
class TrainConfig:
    """The training loop's knobs (``repro_torch.train``)."""

    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1_000
    grad_clip: float = 1.0
    optimizer: str = "adamw"          # adamw | adafactor | sgd
    microbatches: int = 1             # gradient accumulation factor
    remat: str = "block"              # none | block | full
    grad_compress_bits: int = 0       # 0 = off; 8 = int8 error feedback
    seed: int = 0


@dataclass(frozen=True)
class RunConfig:
    """Everything needed to describe one (arch x shape x mesh) cell."""

    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
