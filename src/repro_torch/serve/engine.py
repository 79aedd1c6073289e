"""Continuous-batching serving engine over a paged KV cache (the default
for the dense, vlm, audio and moe families) or a fixed-slot cache (the
ssm and hybrid families' mode).

**Paged mode** (``mode="paged"``): KV state lives in a shared page pool
(:mod:`repro_torch.serve.pages`) addressed through per-request block
tables; the scheduler (:mod:`repro_torch.serve.scheduler`: FCFS, or
``sched="budget"`` for a per-step token budget with weighted fair share)
admits requests by page capacity, prefills prompts in batched chunks
through ``prefill_chunk`` (one forward per chunk across all pending
lanes), decodes one token per step for every ready lane, and preempts the
longest-running request when pages run out.  With ``prefix_cache`` the
pages of completed prompts are shared through a radix tree
(:mod:`repro_torch.serve.prefix_cache`), and a request prefills only the
suffix that no resident page holds.  ``audit`` (``ServeConfig.audit`` 1 /
2) proves the allocator's, the tree's and the scheduler's invariants
after every step (and phase).  :mod:`repro_torch.serve.frontend` streams
tokens over this engine.

**Fixed-slot mode** (``mode="slots"``, and what ``mode="auto"`` falls
back to, with a warning, for the ssm and hybrid families, whose O(1)
recurrent state has nothing to page; ``mode="paged"`` refuses them): a
fixed ``(n_slots, max_len)`` cache rectangle,
prompts entering by sequential decode one slot at a time, and one
full-sequence ``decode_step`` per token across the active slots.  A slot
that does not advance keeps every cache entry bit-identical, as the JAX
package's ``_merge_cache`` leaves it: ``decode_step``'s ``active`` lanes
select where the step writes (the K/V row of each lane — for the hybrid
family at each shared-attention site — the conv and h states it writes
whole anyway, ``pos``), never the whole cache.

Every linear runs through one :class:`~repro_torch.engine.EnginePlan`
resolved at construction; with ``EngineConfig.kv_bits = 8`` the pools are
int8 (paged mode only).  On a CUDA device the plan's ``auto`` backends are
the hand-written kernels (GEMV and paged attention); on the CPU they are
the plain PyTorch paths.

On a CUDA device each fixed-shape step (the paged decode step at
``(n_slots, 1)``, the prefill chunk at ``(n_slots, chunk)``, the slots
step at ``(n_slots, 1)``) is a captured CUDA graph replayed from static
lane buffers (:mod:`repro_torch.serve.step_graph`), the port's
counterpart of the JAX package's ``jax.jit`` of ``_dec``, ``_pf`` and
``_step``.  ``cuda_graphs=False`` runs them eagerly, as
``jax.disable_jit()`` would; on the CPU they always run eagerly.

**Step anatomy** (``ServeEngine.timings``, always on, on
``time.perf_counter``, never the injected clock): every ``step()``'s host
seconds, and for each part (a paged prefill chunk, a slots prompt's
prefill, a decode step) its host seconds, the host seconds inside its
step calls (``_launch``: the graph launch and the launch counters; on a
mesh every segment and the host collectives between them) and, on a
card, two device readings from timing events: from an event recorded on
the stream at the part's start to the step's first node (``_start``: the
gap the lane loads and the launch open before the step runs), and from
that node to the step's last (``_device``).  The step's events are its
:class:`~repro_torch.serve.step_graph.MarkedStep` pair, captured into
its graph; a slots prompt's prefill replays the step once a token, so
its ``_device`` runs from an event recorded before its first step call,
as on the eager path.  The events are read after the part's logits
synchronise; no reading adds a sync.

**Telemetry** (:mod:`repro_torch.obs`): with ``repro_torch.obs``
enabled, or an explicit ``telemetry=``, every step is framed into admit /
prefill / decode phases and every request transition, prefill chunk and
decode step reports to a :class:`~repro_torch.obs.Telemetry`, whose cost
ledger is charged each step's modeled FLOPs and bytes
(:mod:`repro_torch.obs.costs`); ``metrics()`` returns the snapshot.  The
hooks run around each step's replay and the host read of its logits,
never inside a captured step.  With obs off the engine holds
``NULL_TELEMETRY``: no extra clock read, no state.

**Fault isolation** (paged mode): a lane whose step fails (a
``ChaosInjector``'s ``step_fault``) or whose fresh logits are non-finite
is retried recompute-style, as a preemption, within its request's budget
(``ServeConfig.max_request_retries`` / ``retry_reset_steps``, one
:class:`~repro_torch.ft.RestartPolicy` per request) and quarantined past
it (``finish_reason="error"``); either way its private pages are zeroed
in place first (:func:`~repro_torch.serve.pages.scrub_pages`) and every
other lane is untouched.  ``chaos=`` (a
:class:`~repro_torch.ft.ChaosInjector`) drives the engine's sites
(``page_grant``, ``step_fault``, ``nan_logits``, ``preempt_storm``) and
the front end's (``cancel``, ``deadline_skew``); slots mode, like the JAX
package's, injects none and checks no logits.

**Snapshot / restore** (paged mode): :meth:`ServeEngine.snapshot` copies
every piece of serving state to host memory (the page pool, the sampling
generator, the allocator, the prefix cache's tree, the scheduler and every
in-flight request) under the JAX package's array names and host JSON, and
:meth:`~ServeEngine.restore` writes it back in place, into the pool the
step graphs captured, so a restored engine resumes on its graphs;
:meth:`~ServeEngine.save_snapshot` / :meth:`~ServeEngine.load_snapshot`
persist it through :mod:`repro_torch.ckpt`, in the JAX package's format
(a snapshot the JAX engine saved loads here).

**The moe family** serves in both modes.  Each paged step fills an ``(L,
E)`` int32 table of rows per expert on the card (``expert_counts``, one
per step kind, written in place so the graphs refill it); after the step
the engine reads it with the logits and keeps the experts it touched,
summed over layers, in ``experts_touched["decode" | "prefill"]``: the
expert codes a grouped launch actually read (``obs.routed_costs`` prices
a step on them beside the ledger's all-experts price).

**The audio family** (musicgen) keeps the JAX package's token layout:
every prompt id and every sampled token is broadcast over the K
codebooks (step tokens ``(n_slots, 1, K)``, chunk tokens ``(n_slots,
chunk, K)``), a request's ``last_logits`` are ``(K, V)``, and the next
token is sampled from codebook 0.  The prefix cache keys on the single
id.  **The vlm family** serves text prompts: images enter through
``forward`` / ``prefill``'s ``img_embeds`` only, as in the JAX package.

In slots mode the paged-pool options (prefix cache, budget scheduler,
audits) are refused or warned about as the JAX package does.

**On a mesh** (``mesh=``, this process's rank of a ``(data, model)``
:class:`~repro_torch.dist.hints.Mesh`; every family, in each mode it
serves): every rank constructs the same engine from the same params and
receives the same submissions, and holds only its shards.  The params
are placed by ``dist.sharding.serve_param_specs`` (JAX's
``param_shardings`` with whole heads, MoE experts over ``model``, SSM
blocks whole) and cut by ``local_shard``; packed weights then run the
``sharded`` backend (``EngineConfig(sharded=True)``).  The pool, or the
slots cache, holds the rank's KV heads.  The host schedule (scheduler,
allocator, prefix cache, preemption, sampling; in slots mode the
one-token prompt steps, which every rank runs, a data shard that does
not own the prompt's lane with none active) runs identically on every
rank, and every step's logits are gathered to full width and over all
lanes before sampling, so every rank samples the same tokens and
``run()`` returns the same requests everywhere.

Lanes shard over the data axes where they divide over them, in both
modes; in paged mode pages with them: data shard r runs only its lanes, which draw pages only
from its own range of the pool (``ShardedPageAllocator``), and its ranks
hold that range alone and read it through local page ids.  The JAX
package keeps the pool sharded over data but all-gathers it before every
kernel; at ``main``'s size that is ≈151 MB a step, which the port does
not move.  Lanes and pages stay whole over the data axes (every data
shard computes every lane) where the lanes do not divide, where a shard's
range could not hold one ``max_len`` request, or with the prefix cache
(a cached page may serve any lane).  ``mesh_layout`` says which.

On a CUDA device a mesh rank's steps are graphs too, in segments: a
step's compute between two collectives is one captured graph, and the
host runs each collective on ``gloo`` between the replays of the
segments around it, on the buffers they read and write
(:class:`~repro_torch.serve.step_graph.SegmentedStepGraph`).  A step on
a mesh whose model axis has one rank runs no collective inside it and is
one segment; the logits' gather over the data axes stays outside the
graphs, before the host reads them.  On NCCL (one card a rank)
``cuda_graphs`` must be False: the whole step captured over NCCL is
``ROADMAP.md`` queue 1 item 8 (e)'s remaining part.  A snapshot on a
mesh holds the pool
at one device's names and shape (every rank gathers it: heads over
``model``, page ranges over data) and every rank returns the same one;
a restore cuts each rank's block back out, so a snapshot moves between a
mesh and one device (this package's engine or the JAX package's) where
the geometry agrees (a data-sharded pool's per-shard null pages are
listed free in it).  Chaos injection runs on a mesh as on one device:
its decisions are host-side, every rank runs the same host schedule and
so fires the same faults at the same checks, each after the step's
collectives; a faulted lane's pages are zeroed by the data shard that
holds them, in its local page ids.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import time
from typing import Callable, Deque, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.config.base import (
    FAMILIES,
    PAGED_FAMILIES,
    ModelConfig,
    ServeConfig,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import collectives
from repro_torch.dist.collectives import all_gather
from repro_torch.dist.sharding import (
    local_shard,
    pool_pages_for_mesh,
    serve_param_specs,
)
from repro_torch.engine import resolve_attn_backend, resolve_plan
from repro_torch.engine.sharded import lane_partition
from repro_torch.ft.failures import RestartPolicy
from repro_torch.models.transformer import (
    decode_step,
    decode_step_paged,
    init_cache,
    prefill_chunk as _prefill_chunk_fn,
    quantize_params,
    rank_view,
)
from repro_torch.serve.pages import (
    NULL_PAGE,
    AuditError,
    LaneTables,
    PageAllocator,
    ShardedPageAllocator,
    fork_tail_page,
    init_kv_pages,
    pages_for,
    scrub_pages,
)
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.sampler import sample
from repro_torch.serve.scheduler import (
    PRIORITY_WEIGHTS,
    BudgetScheduler,
    PagedScheduler,
)
from repro_torch.serve.step_graph import (
    MarkedStep,
    SegmentedStepGraph,
    StepGraph,
)

logger = logging.getLogger(__name__)

class AdmissionRejected(RuntimeError):
    """Load shedding: ``submit`` refused the request (``reason`` is
    ``"queue_full"`` or ``"pool_too_small"``)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# eq=False: a Request is an identity (queue membership and lane residency
# compare by ``is``)
@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # logits of the most recent token, fed to the next sampling step
    last_logits: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)
    prefill_tokens: List[int] = dataclasses.field(
        default_factory=list, repr=False)
    prefill_pos: int = 0
    admit_seq: int = -1
    preemptions: int = 0
    # prefill tokens served from the prefix cache at (re-)admission
    cached_tokens: int = 0
    # clock reading at ``submit()``: the anchor of per-request latency
    submit_t: float = 0.0
    # time to first token, from ``submit_t``
    ttft: Optional[float] = None
    priority: str = "default"         # interactive | default | batch
    tenant: str = "default"           # fair-share accounting key part
    cancelled: bool = False
    # "length" | "cancelled" | "timed_out" | "error" (None while running)
    finish_reason: Optional[str] = None
    # recompute-style retries after step faults / non-finite logits
    retries: int = 0


def _resolve_mode(mode: str, family: str) -> Tuple[str, bool]:
    """``(mode, auto_fallback)`` as the JAX package resolves them: ``auto``
    is paged for the families with a pageable KV cache and slots, with a
    warning that names the family, for the others."""
    if mode == "auto":
        if family in PAGED_FAMILIES:
            return "paged", False
        logger.warning(
            "ServeEngine: family %r has no pageable KV cache; falling back "
            "to mode='slots' (fixed-slot engine, no paging, no prefix "
            "cache)", family)
        return "slots", True
    if mode == "paged" and family not in PAGED_FAMILIES:
        raise ValueError(f"family {family!r} has no pageable KV cache; "
                         "use mode='slots'")
    if mode not in ("paged", "slots"):
        raise ValueError(f"unknown serve mode {mode!r}")
    return mode, False


def _check_slots_options(scfg: ServeConfig, prefix_cache: bool,
                         auto_fallback: bool) -> None:
    """The paged-pool options in slots mode, as the JAX package treats
    them: refused with ``ValueError`` when slots mode was asked for;
    after ``auto``'s fallback the prefix cache is dropped silently (the
    fallback's warning names the family) and the others are ignored with
    a warning."""
    if prefix_cache and not auto_fallback:
        raise ValueError(
            "prefix_cache shares KV *pages* across requests; mode='slots' "
            "has no page pool to share")
    if scfg.sched == "budget":
        if not auto_fallback:
            raise ValueError(
                "sched='budget' interleaves chunked prefill with decode "
                "under a token budget; mode='slots' prefills synchronously "
                "and has no scheduler to budget")
        logger.warning("ServeEngine: sched='budget' ignored in mode='slots' "
                       "(fixed-slot fallback runs FCFS)")
    if scfg.audit:
        if not auto_fallback:
            raise ValueError("audit proves page-pool invariants; "
                             "mode='slots' has no page pool to audit")
        logger.warning("ServeEngine: audit ignored in mode='slots' "
                       "(no page pool)")


def _check_mesh_options(cuda_graphs: bool, backend: Optional[str]) -> None:
    """What a mesh does not serve yet raises, naming where it is queued:
    graphs over ``backend`` ``nccl``."""
    if cuda_graphs and backend == "nccl":
        raise ValueError(
            "cuda_graphs=True on an NCCL mesh: graphs on a mesh are cut at "
            "its collectives, which run as host calls on gloo between the "
            "segments; the whole step captured over NCCL on two or more "
            "cards is not ported (ROADMAP.md queue 1 item 8 (e)); pass "
            "cuda_graphs=False")


def _host_tensor(a) -> torch.Tensor:
    """A snapshot array as a CPU tensor: a tensor as it is, a numpy array
    without a copy (a bfloat16 one, from the JAX package, through its
    2-byte payload)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class ServeEngine:
    """Continuous-batching serving over a paged or a fixed-slot cache.

    ``device``: where the model runs; None means the GPU, and raises on a
    host without one.  ``params`` are quantized at construction when the
    plan packs weights.  ``mode``: ``"paged"`` | ``"slots"`` | ``"auto"``
    (None defers to ``ServeConfig.mode``).  ``page_size`` / ``n_pages`` /
    ``prefill_chunk`` configure the paged pool and default to the
    :class:`ServeConfig`'s; ``n_pages=0`` sizes the pool to the full
    ``n_slots × max_len`` rectangle (never preempts).  ``attn_backend``
    (``gather`` / ``cuda``) overrides the plan's.

    ``prefix_cache``: share KV pages across requests through a radix tree
    of resident pages (paged mode only); a bool, None defers to
    ``ServeConfig.prefix_cache``.  The engine builds and owns the
    :class:`PrefixCache` over its own pool.  ``clock``: the timebase of
    ``Request.submit_t``, ``ttft`` and the telemetry's spans (default
    :func:`repro_torch.obs.clock.now`); a test injects a manual one.
    ``telemetry``: an explicit ``Telemetry`` / ``NullTelemetry``; None
    defers to the process-wide ``repro_torch.obs`` switch.  ``chaos``: an
    optional :class:`~repro_torch.ft.ChaosInjector` whose faults report
    through this engine's telemetry.

    ``cuda_graphs``: on a CUDA device, run each step as a replayed CUDA
    graph (the default) or eagerly (False); the params and the pool or
    cache are captured by address and must not be rebound.  ``mesh``:
    serve as this rank of a mesh (see the module docstring); its
    ``device`` is the default device; its steps' graphs are segmented at
    the collectives, and ``cuda_graphs`` must be False on NCCL.
    ``timings`` records the host-clock seconds of every prefill chunk (in
    slots mode, every prompt's sequential prefill) and decode step, each
    measured up to the host sync that reads its logits, and apart from
    them the seconds of each graph capture (``"capture"``) and of each
    audit (``"audit"``); on a mesh, the seconds inside collectives
    (``"collectives"``) and waiting for the device before them
    (``"collective_wait"``) up to each logits read (a step; in slots
    mode, a prompt's sequential prefill too).  Beside ``"prefill"`` and
    ``"decode"``, index for index, ``"<part>_launch"`` (host seconds
    inside the part's step calls) and, on a card only,
    ``"<part>_start"`` and ``"<part>_device"`` (device seconds; the
    module docstring's step anatomy); ``"step"`` holds every ``step()``'s
    host seconds, empty steps included.  Graph captures are left out of
    each.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        scfg: Optional[ServeConfig] = None,
        *,
        n_slots: int = 4,
        max_len: int = 256,
        seed: int = 0,
        mode: Optional[str] = None,
        page_size: Optional[int] = None,
        n_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        prefix_cache: Optional[bool] = None,
        attn_backend: Optional[str] = None,
        cuda_graphs: bool = True,
        clock: Optional[Callable[[], float]] = None,
        device: DeviceLike = None,
        telemetry=None,
        chaos=None,
        mesh=None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.scfg = scfg or ServeConfig()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {cfg.family!r}")
        self.mode, auto_fallback = _resolve_mode(mode or self.scfg.mode,
                                                 cfg.family)
        if prefix_cache is None:
            prefix_cache = self.scfg.prefix_cache
        if not isinstance(prefix_cache, bool):
            # an instance would index another pool's pages (and an empty
            # one is falsy): refuse rather than surprise
            raise TypeError(
                f"prefix_cache must be a bool (got "
                f"{type(prefix_cache).__name__}); the engine builds and "
                "owns the PrefixCache over its own page pool")
        if self.mode == "slots":
            _check_slots_options(self.scfg, prefix_cache, auto_fallback)
        self._clock = clock if clock is not None else obs.clock.now
        self.obs = (telemetry if telemetry is not None
                    else obs.telemetry(clock))
        self.chaos = chaos
        if chaos is not None:
            # every fired fault reports through the engine's telemetry,
            # the allocator's page_grant site included
            chaos.obs = self.obs
        if mesh is not None:
            _check_mesh_options(cuda_graphs, collectives.backend())
            if device is None:
                device = mesh.device
        self.device = resolve_device(device)
        # the EngineConfig is resolved into an EnginePlan exactly once
        self.plan = resolve_plan(self.scfg.engine, device=self.device,
                                 mesh=mesh)
        self.kv_bits = self.plan.kv_bits if self.plan is not None else 0
        if self.kv_bits and self.mode == "slots":
            raise ValueError(
                "kv_bits is wired through the paged engine (int8 KV pages); "
                "mode='slots' serves the full-precision cache only")
        if self.plan is not None and self.plan.bits:
            params = quantize_params(params, cfg, self.plan.bits)
        if mesh is not None:
            params = self._shard_params(params)
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.generator = torch.Generator().manual_seed(seed)
        self.attn_backend = resolve_attn_backend(
            attn_backend
            or (self.plan.attn_backend if self.plan is not None
                else self.scfg.engine.attn_backend),
            self.device)
        self._next_rid = 0
        self.shed_count = 0  # AdmissionRejected raised since construction
        self.quarantined = 0  # requests finished with finish_reason="error"
        self.retried = 0  # recompute-style retries granted across requests
        self._engine_step = 0
        # per-request retry budgets (rid -> RestartPolicy), created at the
        # first fault, dropped at terminal states
        self._retry: Dict[int, RestartPolicy] = {}
        self._errored_step: List[Request] = []
        self.obs.attach_engine(n_slots, self.mode)
        self.timings: Dict[str, List[float]] = {
            key: [] for key in (
                "prefill", "prefill_launch", "prefill_start",
                "prefill_device", "decode", "decode_launch", "decode_start",
                "decode_device", "step", "capture", "audit", "collectives",
                "collective_wait")}
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        # the step anatomy's device events (card only): each part's start,
        # and the start of a part that calls its step more than once; each
        # step function's pair, by the parts that run it
        self._part_start = self._part_first = self._stream = None
        if self.device.type == "cuda":
            self._part_start = torch.cuda.Event(enable_timing=True)
            self._part_first = torch.cuda.Event(enable_timing=True)
        self._marks: Dict[str, MarkedStep] = {}
        self._launch_s = 0.0
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.cuda_graphs else None)
        self._graphs: List[StepGraph] = []
        # the audio family's codebooks, over which every token id is
        # broadcast (0 for the other families)
        self._codebooks = cfg.n_codebooks if cfg.family == "audio" else 0
        self.prefix_cache: Optional[PrefixCache] = None
        # the moe family's rows per expert of the latest step of each kind
        self.expert_counts: Optional[Dict[str, torch.Tensor]] = None
        self.experts_touched: Dict[str, List[int]] = {"decode": [],
                                                      "prefill": []}
        if self.mode == "paged":
            self._init_paged(page_size, n_pages, prefill_chunk, prefix_cache)
        else:
            self._init_slots()

    def _init_paged(self, page_size, n_pages, prefill_chunk,
                    prefix_cache: bool) -> None:
        self.page_size = page_size or self.scfg.page_size
        self.prefill_chunk = prefill_chunk or self.scfg.prefill_chunk
        self._max_blocks = pages_for(self.max_len, self.page_size)
        if n_pages is None:
            n_pages = self.scfg.n_pages
        if not n_pages:  # full rectangle + null page: never preempts
            n_pages = self.n_slots * self._max_blocks + 1
        n_pages, lanes_local, pool_pages = self._mesh_layout(n_pages,
                                                              prefix_cache)
        self.pages = init_kv_pages(self.cfg, pool_pages, self.page_size,
                                   kv_bits=self.kv_bits, device=self.device,
                                   n_kv_heads=self._kv_heads)
        if self._lane_shard is not None:
            self.alloc = ShardedPageAllocator(
                n_pages, self.page_size, self.n_slots, self.max_len,
                self.mesh_layout["data_shards"], obs=self.obs)
        else:
            self.alloc = PageAllocator(n_pages, self.page_size, self.n_slots,
                                       self.max_len, obs=self.obs)
        self.alloc.chaos = self.chaos  # page_grant fault site
        if prefix_cache:  # attaches itself to the allocator
            self.prefix_cache = PrefixCache(self.alloc, obs=self.obs)
        if self.scfg.sched == "budget":
            # default budget: every lane decodes plus one full prefill
            # chunk a step
            self.sched = BudgetScheduler(
                self.alloc, self.prefill_chunk,
                prefix_cache=self.prefix_cache, obs=self.obs,
                step_tokens=(self.scfg.step_tokens
                             or self.n_slots + self.prefill_chunk))
        else:
            self.sched = PagedScheduler(self.alloc, self.prefill_chunk,
                                        prefix_cache=self.prefix_cache,
                                        obs=self.obs)
        # the scheduler's own queue and lane table, under the names slots
        # mode gives its own
        self.queue, self.slot_req = self.sched.queue, self.sched.slot_req
        self.lanes = LaneTables(lanes_local, self.device,
                                max_blocks=self._max_blocks,
                                chunk=self.prefill_chunk,
                                codebooks=self._codebooks)
        params, pages, lanes = self.params, self.pages, self.lanes
        cfg, plan, abk = self.cfg, self.plan, self.attn_backend
        mesh = self.mesh
        counts = {"decode": None, "prefill": None}
        if cfg.family == "moe":
            counts = self.expert_counts = {
                kind: torch.zeros((cfg.n_layers, cfg.n_experts),
                                  dtype=torch.int32, device=self.device)
                for kind in counts}
        self._decode_paged = self._step_fn(lambda: decode_step_paged(
            params, pages, lanes.block_tables, lanes.pos, lanes.active,
            lanes.tokens, cfg, plan, attn_backend=abk,
            expert_counts=counts["decode"], mesh=mesh), "decode")
        self._prefill_paged = self._step_fn(lambda: _prefill_chunk_fn(
            params, pages, lanes.block_tables, lanes.chunk_tokens,
            lanes.pos0, lanes.seq_lens, cfg, plan, attn_backend=abk,
            expert_counts=counts["prefill"], mesh=mesh), "prefill")
        # the cost ledger's tables: the steps' shapes are fixed at
        # construction, so one table per step kind prices every step.
        # Built at the first charged step; with obs off they never exist.
        self._cost_dims = None
        self._cost_specs = None
        self._decode_cost_table = None
        self._prefill_cost_table = None
        self._fork_cost_table = None

    def _init_slots(self) -> None:
        lanes_local = self._slots_layout()
        self.cache = init_cache(self.cfg, lanes_local, self.max_len,
                                device=self.device,
                                n_kv_heads=self._kv_heads)
        self.queue: Deque[Request] = collections.deque()
        self.slot_req: List[Optional[Request]] = [None] * self.n_slots
        self.lanes = LaneTables(lanes_local, self.device,
                                codebooks=self._codebooks)
        params, cache, lanes = self.params, self.cache, self.lanes
        cfg, plan, abk, mesh = self.cfg, self.plan, self.attn_backend, \
            self.mesh
        self._slots_step = self._step_fn(lambda: decode_step(
            params, cache, lanes.tokens, cfg, plan, attn_backend=abk,
            active=lanes.active, mesh=mesh)[0], "prefill", "decode")

    def _step_fn(self, fn, *parts: str):
        """``fn`` as the engine runs it: a :class:`StepGraph` when graphs
        are on (on a mesh a :class:`SegmentedStepGraph`, cut at the
        collectives), else ``fn`` itself; on a card ``fn`` runs between
        its :class:`MarkedStep` events, the device marks of ``parts``.
        Every step's graphs share the engine's pool; each call replays
        all of a step's segments before another step runs, as a shared
        pool needs."""
        if self.device.type == "cuda":
            fn = MarkedStep(fn)
            self._marks.update(dict.fromkeys(parts, fn))
        if not self.cuda_graphs:
            return fn
        kind = StepGraph if self.mesh is None else SegmentedStepGraph
        graph = kind(fn, pool=self._graph_pool)
        self._graphs.append(graph)
        return graph

    # ----------------------------------------------------------------- mesh
    def _shard_params(self, params):
        """This rank's shards of ``params`` (whole on every rank until
        now), placed by ``serve_param_specs``; packed weights need the
        ``sharded`` backend, which sums the row-parallel partials."""
        if (self.plan is not None and self.plan.bits
                and self.plan.backend != "sharded"):
            raise ValueError(
                "packed weights on a mesh run through the sharded backend: "
                "pass EngineConfig(sharded=True)")
        self.param_specs = serve_param_specs(self.mesh, params, self.cfg)
        return local_shard(params, self.param_specs, self.mesh)

    def _lane_shards(self) -> Tuple[int, Optional[str]]:
        """``(data shards the lanes split into, why they stay whole)``,
        with ``_kv_heads`` set to the KV heads this rank holds: lanes over
        the data axes when ``n_slots`` divides them (``lane_partition``)."""
        mesh = self.mesh
        self._kv_heads = rank_view(self.params, self.cfg, mesh).hkv
        _, shards = lane_partition(mesh, "model", self.cfg.n_kv_heads,
                                   self.n_slots)
        why = None
        if shards == 1 and mesh.count(mesh.data_axes()) > 1:
            why = "lanes do not divide over the data axes"
        return shards, why

    def _place_lanes(self, shards: int, why: Optional[str]) -> int:
        """Record the mesh layout (``mesh_layout``; ``why``: the reason
        lanes stay whole over data, which forces one shard) and return
        the data shards the lanes split into; on a lane-sharded mesh, set
        this rank's data shard and that shard's group (``_lane_shard`` /
        ``_lane_group``)."""
        mesh = self.mesh
        if why:
            shards = 1
        self.mesh_layout = {"mesh": dict(mesh.shape),
                            "kv_heads": self._kv_heads,
                            "data_shards": shards,
                            "whole_over_data": why}
        # this engine's steps count their collectives' seconds from here
        collectives.reset_seconds()
        if shards > 1:
            daxes = mesh.data_axes()
            self._lane_shard = mesh.index(daxes)
            self._lane_group = mesh.group(daxes)
        return shards

    def _mesh_layout(self, n_pages: int, prefix_cache: bool):
        """``(n_pages, lanes this rank runs, pages this rank holds)`` of
        paged mode: KV heads over ``model`` when they divide, lanes and
        pages over the data axes when the module docstring's conditions
        hold."""
        self._lane_shard = self._lane_group = None
        self._kv_heads = self.mesh_layout = None
        if self.mesh is None:
            return n_pages, self.n_slots, n_pages
        shards, why = self._lane_shards()
        padded = pool_pages_for_mesh(n_pages, self.mesh)
        if shards > 1 and prefix_cache:
            why = "the prefix cache may share a page with any lane"
        elif shards > 1 and padded // shards < self._max_blocks + 1:
            why = (f"a shard's {padded // shards} pages cannot hold one "
                   f"max_len request")
        shards = self._place_lanes(shards, why)
        if shards == 1:
            return n_pages, self.n_slots, n_pages
        return padded, self.n_slots // shards, padded // shards

    def _slots_layout(self) -> int:
        """The lanes this rank runs in slots mode, and the KV heads of its
        cache (``_kv_heads``; None: all): lanes over the data axes when
        they divide, KV heads as the rank's attention shards hold them."""
        self._lane_shard = self._lane_group = None
        self._kv_heads = self.mesh_layout = None
        if self.mesh is None:
            return self.n_slots
        return self.n_slots // self._place_lanes(*self._lane_shards())

    def _lane_range(self) -> Tuple[int, int]:
        """``(first, count)`` of the lanes this rank runs: all of them, or
        on a lane-sharded mesh its data shard's contiguous block."""
        n = self.lanes.active.shape[0]
        return (0 if self._lane_shard is None else self._lane_shard * n), n

    def _local_lane(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's lane buffers, or None where
        another data shard runs it."""
        lo, n = self._lane_range()
        return slot - lo if lo <= slot < lo + n else None

    def _load_lanes(self, **arrays) -> None:
        """Refill the lane buffers; on a lane-sharded mesh with this data
        shard's rows, its block tables in local page ids."""
        if self._lane_shard is not None:
            lo, n = self._lane_range()
            arrays = {k: np.asarray(v)[lo:lo + n] for k, v in arrays.items()}
            if "block_tables" in arrays:
                arrays["block_tables"] = self.alloc.local_pages(
                    arrays["block_tables"], self._lane_shard)
        self.lanes.load(**arrays)

    def _pool_cuts(self) -> Tuple[Optional[object], Optional[object]]:
        """``(head group, page group)``: the groups over which this rank's
        pool is a block of the whole one (the KV-head axis 3 over
        ``model``, the page axis 1 over the data shards), each None where
        the rank holds the axis whole."""
        if self.mesh is None:
            return None, None
        heads = (self.mesh.group("model")
                 if self._kv_heads != self.cfg.n_kv_heads else None)
        return heads, self._lane_group

    # ------------------------------------------------------------------ API
    def submit(self, prompt: List[int],
               max_new_tokens: Optional[int] = None, *,
               priority: str = "default",
               tenant: str = "default") -> Request:
        """Enqueue a prompt; returns its :class:`Request`.  Raises
        ``ValueError`` for a malformed prompt or an unknown ``priority``
        and :class:`AdmissionRejected` when the bounded queue is full or
        the prompt can never fit the pool.  ``priority`` and ``tenant``
        are the budget scheduler's fair-share key."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError(
                "empty prompt: submit at least one token (e.g. BOS)")
        if min(prompt) < 0 or max(prompt) >= self.cfg.vocab_size:
            bad = next(t for t in prompt
                       if t < 0 or t >= self.cfg.vocab_size)
            raise ValueError(
                f"prompt token {bad} outside the model vocabulary "
                f"[0, {self.cfg.vocab_size})")
        if len(prompt) > self.max_len - 2:
            raise ValueError(
                f"prompt of {len(prompt)} tokens cannot fit max_len="
                f"{self.max_len} with room to generate (limit is "
                f"max_len - 2 = {self.max_len - 2})")
        if priority not in PRIORITY_WEIGHTS:
            raise ValueError(
                f"unknown priority {priority!r}; choose from "
                f"{sorted(PRIORITY_WEIGHTS)}")
        if self.scfg.max_queue and len(self.queue) >= self.scfg.max_queue:
            self.shed_count += 1
            self.obs.on_shed("queue_full")
            raise AdmissionRejected("queue_full")
        if (self.mode == "paged"
                and pages_for(len(prompt) + 1, self.page_size)
                > self.alloc.capacity):
            self.shed_count += 1
            self.obs.on_shed("pool_too_small")
            raise AdmissionRejected("pool_too_small")
        req = Request(self._next_rid, prompt,
                      self.scfg.max_new_tokens if max_new_tokens is None
                      else max_new_tokens,
                      priority=priority, tenant=tenant)
        req.prefill_tokens = list(prompt)
        req.submit_t = self._clock()
        self._next_rid += 1
        self.queue.append(req)
        self.obs.on_submit(req.rid, len(prompt), req.submit_t)
        return req

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def step(self) -> List[Request]:
        """One scheduler iteration (admit -> prefill -> decode token ->
        retire); returns the requests that finished this step, the
        quarantined ones included.  Framed for the telemetry: a step span
        on the engine track, the step counter and its duration."""
        t0 = self.obs.now()
        t_step, captured = time.perf_counter(), self.capture_seconds
        self.obs.step_begin()
        try:
            if self.mode == "slots":
                return self._step_slots()
            return self._step_paged()
        finally:
            self.obs.step_end(t0)
            self.timings["step"].append(
                time.perf_counter() - t_step
                - (self.capture_seconds - captured))

    def _step_paged(self) -> List[Request]:
        self._engine_step += 1
        self._errored_step = []  # quarantines land here (terminal too)
        if self.chaos is not None and self.chaos.fire("preempt_storm"):
            # mass eviction drill: recompute-style, token-preserving
            self.sched.preempt_storm()
        with self.obs.phase("admit"):
            self.sched.admit()
            self._apply_forks()
        self._maybe_audit(2)
        with self.obs.phase("prefill"):
            self._prefill_once()
        self._maybe_audit(2)
        # pre-decode retire: max_new_tokens=0 must emit no tokens
        finished = self._retire(limit_only=True)
        with self.obs.phase("decode"):
            self._decode_once_paged()
        self._maybe_audit(2)
        finished.extend(self._retire())
        self._maybe_audit(1)
        finished.extend(self._errored_step)
        return finished

    def _step_slots(self) -> List[Request]:
        self._admit()
        # pre-decode retire: max_new_tokens=0 must emit no tokens
        finished = self._retire(limit_only=True)
        self._decode_one()
        finished.extend(self._retire())
        return finished

    def run(self) -> List[Request]:
        """Drive until queue and lanes drain; returns completed requests."""
        finished: List[Request] = []
        while self.has_work():
            finished.extend(self.step())
        return finished

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Terminate a request now, wherever it is.  In paged mode its
        pages are released at once (prefix-cache pins and the private
        pages of a chunked prefill included) and its pending
        copy-on-write forks are dropped before their target page can be
        reused.  Tokens generated so far stay on ``req.output``.  Returns
        False if it had already reached a terminal state."""
        if req.done or req.cancelled:
            return False
        req.cancelled = True
        req.finish_reason = reason
        self._retry.pop(req.rid, None)
        self.obs.on_cancel(req.rid, reason)
        for slot, r in enumerate(self.slot_req):
            if r is req:
                if self.mode == "paged":
                    self.sched.drop_forks(slot)
                    self.alloc.free_slot(slot)
                self.slot_req[slot] = None
                return True
        if req in self.queue:
            self.queue.remove(req)
        return True

    def request_phase(self, req: Request) -> str:
        """Lifecycle phase: ``queued`` | ``prefilling`` | ``decoding`` |
        ``done`` | ``cancelled`` (the front end tells cancelled and timed
        out apart by ``finish_reason``)."""
        if req.done:
            return "done"
        if req.cancelled:
            return "cancelled"
        for r in self.slot_req:
            if r is req:
                if (req.last_logits is None
                        or req.prefill_pos < len(req.prefill_tokens)):
                    return "prefilling"
                return "decoding"
        return "queued"

    @property
    def preemptions(self) -> int:
        return self.sched.preemptions if self.mode == "paged" else 0

    @property
    def prefill_computed(self) -> int:
        """Prompt tokens actually run through ``prefill_chunk`` (cache
        hits keep it below the total of the submitted prompts)."""
        return self.sched.prefill_computed if self.mode == "paged" else 0

    def prefix_stats(self) -> Optional[Dict[str, int]]:
        """The prefix cache's counters, or None without a cache."""
        return (self.prefix_cache.stats()
                if self.prefix_cache is not None else None)

    def metrics(self) -> Dict:
        """The engine's snapshot, with the JAX package's keys: lifecycle
        counters, the prefix cache's stats when a cache is attached, the
        fault-isolation counters and the chaos injector's fired faults
        (``ft``), and with telemetry on its snapshot (``obs``: steps,
        request states, the registry) and the cost ledger (``costs``)."""
        out: Dict = {
            "mode": self.mode,
            "submitted": self._next_rid,
            "shed": self.shed_count,
            "preemptions": self.preemptions,
            "quarantined": self.quarantined,
            "prefill_computed": self.prefill_computed,
        }
        if self.prefix_cache is not None:
            out["prefix"] = self.prefix_cache.stats()
        out["ft"] = {
            "quarantined": self.quarantined,
            "retried": self.retried,
            "chaos": (self.chaos.summary()
                      if self.chaos is not None else {}),
        }
        if self.obs.enabled:
            out["obs"] = self.obs.snapshot()
            out["costs"] = self.obs.costs.snapshot()
        return out

    # ---------------------------------------------------- cost attribution
    def _cost_base(self):
        """Model dims + the live parameters' linear specs (packed weights
        price at ``bits/8`` bytes a weight)."""
        if self._cost_specs is None:
            self._cost_dims = obs.model_dims(self.cfg)
            self._cost_specs = obs.linear_specs(self.params)
        return self._cost_dims, self._cost_specs

    def _charge_decode(self, rids) -> None:
        """Charge one paged decode step to the ledger.  The step always
        runs the full ``(n_slots, max_blocks·page_size)`` shapes however
        many lanes are active, so one table is exact for every step; the
        total is split across the lanes that decoded.  The activations
        are priced at the tables' default 4 bytes, as the JAX package's
        engine prices them."""
        if not self.obs.enabled:
            return
        if self._decode_cost_table is None:
            dims, specs = self._cost_base()
            self._decode_cost_table = obs.decode_step_costs(
                dims, batch=self.n_slots,
                context=self._max_blocks * self.page_size,
                page_size=self.page_size, attn_backend=self.attn_backend,
                kv_bits=self.kv_bits, specs=specs)
        self.obs.on_costs(self._decode_cost_table, rids)

    def _charge_prefill(self, rids) -> None:
        """Charge one prefill chunk (``(n_slots, chunk)``, padded; see
        :meth:`_charge_decode`)."""
        if not self.obs.enabled:
            return
        if self._prefill_cost_table is None:
            dims, specs = self._cost_base()
            self._prefill_cost_table = obs.prefill_chunk_costs(
                dims, batch=self.n_slots, chunk=self.prefill_chunk,
                context=self._max_blocks * self.page_size,
                page_size=self.page_size, attn_backend=self.attn_backend,
                kv_bits=self.kv_bits, specs=specs)
        self.obs.on_costs(self._prefill_cost_table, rids)

    def _charge_fork(self, rid: int) -> None:
        """Charge one copy-on-write tail-page fork (pure page copies)."""
        if not self.obs.enabled:
            return
        if self._fork_cost_table is None:
            dims, _ = self._cost_base()
            self._fork_cost_table = obs.fork_cost(
                dims, page_size=self.page_size, kv_bits=self.kv_bits)
        self.obs.on_costs(self._fork_cost_table, (rid,))

    def audit(self) -> None:
        """Prove the host-side bookkeeping invariants of the allocator
        (refcounts, free list, block tables), the prefix cache's radix
        tree and the scheduler (residency, queue, pending forks); raises
        :class:`~repro_torch.serve.pages.AuditError` naming the first
        violation.  Runs after every step (and phase) under
        ``ServeConfig(audit=1)`` (``2``).  Paged mode only."""
        if self.mode != "paged":
            raise ValueError("audit() proves page-pool invariants; "
                             "mode='slots' has no page pool")
        self.alloc.audit()
        if self.prefix_cache is not None:
            self.prefix_cache.audit()
        self._audit_sched()

    def _audit_sched(self) -> None:
        """A live request sits in one place (one lane or the queue), no
        terminal request holds a lane or a queue place, and every pending
        fork's target is a page its owner lane maps."""
        def fail(msg: str) -> None:
            raise AuditError(f"ServeEngine.audit: {msg}")

        resident: Dict[int, int] = {}
        for slot, req in enumerate(self.slot_req):
            if req is None:
                if self.alloc._mapped[slot]:
                    fail(f"empty lane {slot} still maps "
                         f"{len(self.alloc._mapped[slot])} pages")
                continue
            if id(req) in resident:
                fail(f"rid {req.rid} resident in two lanes")
            resident[id(req)] = slot
            if req.done or req.cancelled:
                fail(f"terminal rid {req.rid} still resident in lane "
                     f"{slot}")
        seen_q = set()
        for req in self.queue:
            if id(req) in resident:
                fail(f"rid {req.rid} both queued and resident")
            if id(req) in seen_q:
                fail(f"rid {req.rid} queued twice")
            seen_q.add(id(req))
            if req.done or req.cancelled:
                fail(f"terminal rid {req.rid} still queued")
        for slot, _src, dst in self.sched.pending_forks:
            if self.slot_req[slot] is None:
                fail(f"pending fork owned by empty lane {slot}")
            if dst not in self.alloc._mapped[slot]:
                fail(f"pending fork dst page {dst} not mapped by its "
                     f"owner lane {slot}")

    # ================================================= snapshot / restore
    def _geometry(self) -> Dict:
        return {
            "family": self.cfg.family,
            "n_slots": self.n_slots,
            "max_len": self.max_len,
            "page_size": self.page_size,
            "n_pages": self.alloc.n_pages,
            "prefill_chunk": self.prefill_chunk,
            "kv_bits": self.kv_bits,
            "sched": type(self.sched).__name__,
            "prefix_cache": self.prefix_cache is not None,
        }

    def _pool_tensors(self) -> Dict[str, torch.Tensor]:
        pools = {"pages/k": self.pages.k, "pages/v": self.pages.v}
        if self.pages.quantized:
            pools["pages/k_scale"] = self.pages.k_scale
            pools["pages/v_scale"] = self.pages.v_scale
        return pools

    def snapshot(self) -> Dict:
        """Crash-consistent snapshot of all serving state (paged mode).

        Returns ``{"arrays": {name: array}, "host": <JSON-able>}`` with the
        JAX package's names: the page pool (``pages/k``, ``pages/v`` and,
        for int8 pools, ``pages/k_scale`` / ``pages/v_scale``, as CPU
        tensors), each in-flight request's last logits
        (``logits/<rid>``), and the sampling generator's state
        (``generator``, uint8; the JAX package stores its PRNG key as
        ``key``); the host part holds the geometry, the engine's
        counters, the allocator's tables, the requests, the scheduler
        (with the budget scheduler's virtual time and the pending
        copy-on-write forks), the retry budgets and the prefix cache's
        tree.  Every array is copied to host memory now, so later steps
        cannot change a snapshot taken.  Terminal requests are the
        caller's, not the engine's, and are left out; telemetry state
        restarts fresh.  Persist it with :meth:`save_snapshot`.

        On a mesh every rank calls it (a collective): the pool is gathered
        to one device's shape, and every rank returns the same snapshot.
        """
        if self.mode != "paged":
            raise ValueError("snapshot() covers the paged engine only")
        heads, pages = self._pool_cuts()
        arrays: Dict = {}
        for name, t in self._pool_tensors().items():
            t = t.detach()
            if heads is not None:
                t = all_gather(t, heads, dim=3)
            if pages is not None:
                t = all_gather(t, pages, dim=1)
            arrays[name] = t.to("cpu", copy=True)
        arrays["generator"] = self.generator.get_state().numpy().copy()

        live: List[Request] = [r for r in self.sched.slot_req
                               if r is not None]
        live += [r for r in self.sched.queue if r not in live]
        reqs = []
        for r in live:
            if r.last_logits is not None:
                arrays[f"logits/{r.rid}"] = np.array(r.last_logits)
            reqs.append({
                "rid": r.rid,
                "prompt": [int(t) for t in r.prompt],
                "max_new_tokens": r.max_new_tokens,
                "output": [int(t) for t in r.output],
                "prefill_tokens": [int(t) for t in r.prefill_tokens],
                "prefill_pos": r.prefill_pos,
                "admit_seq": r.admit_seq,
                "preemptions": r.preemptions,
                "cached_tokens": r.cached_tokens,
                "submit_t": r.submit_t,
                "ttft": r.ttft,
                "priority": r.priority,
                "tenant": r.tenant,
                "retries": r.retries,
            })

        sched: Dict = {
            "queue": [r.rid for r in self.sched.queue],
            "slots": [r.rid if r is not None else None
                      for r in self.sched.slot_req],
            "admit_seq": self.sched._admit_seq,
            "preemptions": self.sched.preemptions,
            "prefill_computed": self.sched.prefill_computed,
            "pending_forks": [list(f) for f in self.sched.pending_forks],
        }
        if isinstance(self.sched, BudgetScheduler):
            sched["vtime"] = [[t, p, vt] for (t, p), vt
                              in self.sched._vtime.items()]

        host: Dict = {
            "geometry": self._geometry(),
            "engine": {
                "next_rid": self._next_rid,
                "shed_count": self.shed_count,
                "quarantined": self.quarantined,
                "retried": self.retried,
                "engine_step": self._engine_step,
            },
            "alloc": {
                # a data-sharded pool's shard null pages hold nothing a
                # request reads: listed free, so that a single-device
                # engine (this package's or JAX's) takes them in
                "free": sorted(self.alloc._reserved() - {NULL_PAGE})
                        + [int(p) for p in self.alloc.free],
                "pos": [int(x) for x in self.alloc.pos],
                "mapped": [[int(p) for p in m]
                           for m in self.alloc._mapped],
            },
            "requests": reqs,
            "sched": sched,
            "retry": {str(rid): [pol.restarts, pol.last_failure_step]
                      for rid, pol in self._retry.items()},
        }
        if self.prefix_cache is not None:
            host["cache"] = self.prefix_cache.snapshot_state()
        return {"arrays": arrays, "host": host}

    def restore(self, snap: Dict) -> None:
        """Load a :meth:`snapshot` into this engine, which must have the
        snapshot's geometry (family, lanes, lengths, page pool, kv_bits,
        scheduler class, prefix cache; a mismatch raises ``ValueError``
        naming the fields).  Stepping then resumes where the snapshot was
        taken, with the same greedy tokens.

        Everything is written in place: the pool, its scales and the
        lane buffers keep their storage, because the step graphs read
        them by address, so an engine that has captured its graphs goes
        on replaying them.  A snapshot the JAX engine took (``key``, no
        ``generator``) restores too; this engine then keeps its own
        generator, whose draws differ from JAX's anyway, and greedy
        decoding reads none.

        On a mesh each rank writes its block of the snapshot's pool (its
        KV heads, its data shard's pages) in place as well, so its graph
        segments, and the buffers their collectives share, replay on; a
        snapshot restores across
        placements: mesh and one device either way, where the geometry
        agrees.  Pages this engine holds back (a data-sharded pool's
        per-shard null pages) leave the snapshot's free list; a lane that
        maps a page outside its data shard's range here raises
        ``ValueError`` naming the lane and the page.
        """
        if self.mode != "paged":
            raise ValueError("restore() covers the paged engine only")
        host = snap["host"]
        geom, mine = host["geometry"], self._geometry()
        diff = {k: (geom.get(k), mine[k]) for k in mine
                if geom.get(k) != mine[k]}
        if diff:
            raise ValueError(
                f"snapshot geometry does not match this engine: {diff}")
        alloc = host["alloc"]
        for slot, mapped in enumerate(alloc["mapped"]):
            for page in mapped:
                if not self.alloc._in_pool(slot, int(page)):
                    raise ValueError(
                        f"snapshot lane {slot} maps page {page}, outside "
                        "the pages this engine's placement gives that "
                        "lane")

        arrays = snap["arrays"]
        heads, pages = self._pool_cuts()
        with torch.no_grad():
            for name, pool in self._pool_tensors().items():
                src = _host_tensor(arrays[name])
                if heads is not None:
                    n = pool.shape[3]
                    src = src.narrow(3, self.mesh.index("model") * n, n)
                if pages is not None:
                    n = pool.shape[1]
                    src = src.narrow(1, self._lane_shard * n, n)
                pool.copy_(src)
        if "generator" in arrays:
            self.generator.set_state(
                _host_tensor(arrays["generator"]).to(torch.uint8))

        # allocator first: the cache's blocked recount reads refcounts
        reserved = self.alloc._reserved()
        self.alloc.free[:] = [int(p) for p in alloc["free"]
                              if int(p) not in reserved]
        self.alloc._mapped[:] = [[int(p) for p in m]
                                 for m in alloc["mapped"]]
        self.alloc.pos[:] = alloc["pos"]
        self.alloc.block_tables[:, :] = NULL_PAGE
        self.alloc.refcount[:] = 0
        for slot, mapped in enumerate(self.alloc._mapped):
            for blk, page in enumerate(mapped):
                self.alloc.block_tables[slot, blk] = page
                self.alloc.refcount[page] += 1
        if self.prefix_cache is not None:
            self.prefix_cache.restore_state(host["cache"])

        by_rid: Dict[int, Request] = {}
        for r in host["requests"]:
            req = Request(r["rid"], list(r["prompt"]), r["max_new_tokens"],
                          priority=r["priority"], tenant=r["tenant"])
            req.output = list(r["output"])
            req.prefill_tokens = list(r["prefill_tokens"])
            req.prefill_pos = r["prefill_pos"]
            req.admit_seq = r["admit_seq"]
            req.preemptions = r["preemptions"]
            req.cached_tokens = r["cached_tokens"]
            req.submit_t = r["submit_t"]
            req.ttft = r["ttft"]
            req.retries = r["retries"]
            lg = arrays.get(f"logits/{req.rid}")
            if lg is not None:
                req.last_logits = _host_tensor(lg).float().numpy().copy()
            by_rid[req.rid] = req

        # the scheduler's queue and lane table in place: the engine's
        # ``queue`` / ``slot_req`` are the same objects
        sched = host["sched"]
        self.sched.queue.clear()
        self.sched.queue.extend(by_rid[rid] for rid in sched["queue"])
        self.sched.slot_req[:] = [by_rid[rid] if rid is not None else None
                                  for rid in sched["slots"]]
        self.sched._admit_seq = sched["admit_seq"]
        self.sched.preemptions = sched["preemptions"]
        self.sched.prefill_computed = sched["prefill_computed"]
        self.sched.pending_forks = [
            (int(s), int(src), int(dst))
            for s, src, dst in sched["pending_forks"]]
        if isinstance(self.sched, BudgetScheduler):
            self.sched._vtime = {(t, p): vt
                                 for t, p, vt in sched.get("vtime", [])}

        eng = host["engine"]
        self._next_rid = eng["next_rid"]
        self.shed_count = eng["shed_count"]
        self.quarantined = eng["quarantined"]
        self.retried = eng.get("retried", 0)  # absent in older snapshots
        self._engine_step = eng["engine_step"]
        self._retry = {}
        for rid, (restarts, last_step) in host["retry"].items():
            self._retry[int(rid)] = RestartPolicy(
                max_restarts=self.scfg.max_request_retries, backoff_s=0.0,
                reset_after_steps=self.scfg.retry_reset_steps,
                restarts=restarts, last_failure_step=last_step)
        # in-flight requests resume under this engine's telemetry: fresh
        # timelines open for every restored rid, so their spans end
        # cleanly at retirement
        self.obs.on_restore(sorted(by_rid))

    def save_snapshot(self, directory: str, step: int) -> str:
        """Persist :meth:`snapshot` through :mod:`repro_torch.ckpt`
        (manifest, checksummed shards, atomic commit), in the JAX
        package's layout.  Returns the written path.  On a mesh every
        rank calls it: the first rank writes the (identical) snapshot,
        and every rank returns once it is committed."""
        snap = self.snapshot()
        specs = {name: [list(a.shape), ckpt.dtype_name(a)]
                 for name, a in snap["arrays"].items()}
        path = os.path.join(directory, f"step_{step:08d}")
        if self.mesh is None or self.mesh.rank == 0:
            path = ckpt.save_checkpoint(
                directory, step, snap["arrays"],
                extra={"kind": "serve-engine-snapshot",
                       "host": snap["host"], "array_specs": specs})
        if self.mesh is not None:
            import torch.distributed as dist

            # a barrier over each axis in turn waits for every rank of the
            # mesh (which may be laid over part of the world's ranks)
            for axis in self.mesh.axis_names:
                dist.barrier(group=self.mesh.group(axis))
        return path

    def load_snapshot(self, directory: str,
                      step: Optional[int] = None) -> int:
        """Restore from a :meth:`save_snapshot` directory, this package's
        or the JAX package's (``step=None`` loads the latest committed
        snapshot).  Returns the step loaded.  The template the checkpoint
        loads into is rebuilt from the manifest's ``array_specs``: a
        snapshot describes itself."""
        if step is None:
            step = ckpt.latest_step(directory)
            if step is None:
                raise FileNotFoundError(
                    f"no committed snapshot in {directory}")
        extra = ckpt.read_manifest(directory, step)["extra"]
        if extra.get("kind") != "serve-engine-snapshot":
            raise ValueError(
                f"{directory} step {step} is not a serve-engine snapshot")
        template = {name: ckpt.template_leaf(shape, dt)
                    for name, (shape, dt) in extra["array_specs"].items()}
        arrays, _ = ckpt.load_checkpoint(directory, template, step)
        self.restore({"arrays": arrays, "host": extra["host"]})
        return step

    @property
    def capture_seconds(self) -> float:
        """Host seconds spent capturing this engine's CUDA graphs."""
        return sum(g.capture_seconds for g in self._graphs)

    # ============================================================ internals
    def _host_logits(self, logits: torch.Tensor) -> np.ndarray:
        if self.mesh is None:
            return logits.float().cpu().numpy()  # host sync: the step landed
        # on a mesh, every data shard's lanes first (and the step's host
        # seconds in collectives noted)
        if self._lane_group is not None:
            logits = all_gather(logits, self._lane_group, dim=0)
        out = logits.float().cpu().numpy()
        self.timings["collectives"].append(collectives.SECONDS[0])
        self.timings["collective_wait"].append(collectives.WAIT[0])
        collectives.reset_seconds()
        return out

    def _start_part(self) -> Tuple[float, float]:
        """A part's start: ``(host clock, capture seconds so far)``, and on
        a card its start event recorded on the stream."""
        t0 = time.perf_counter()
        if self._part_start is not None:
            self._part_start.record(self._current_stream())
        return t0, self.capture_seconds

    def _current_stream(self) -> torch.cuda.Stream:
        """The device's current stream, kept while its id holds: building
        one (``torch.cuda.current_stream``) costs the host 8-10 µs on the
        card, reading the id under 0.5 µs."""
        stream = self._stream
        if stream is None or torch._C._cuda_getCurrentStream(
                stream.device_index)[0] != stream.stream_id:
            stream = self._stream = torch.cuda.current_stream(self.device)
        return stream

    def _launch(self, step):
        """``step()``, its host seconds added to the part's launch time."""
        t0 = time.perf_counter()
        out = step()
        self._launch_s += time.perf_counter() - t0
        return out

    def _timed(self, part: str, t0: float, captured: float,
               first: Optional[torch.cuda.Event] = None) -> None:
        """Record a part that started at ``t0``, when the engine's captures
        had taken ``captured`` seconds: a capture made since goes to
        ``timings["capture"]`` and is left out of the part's time and its
        launch time.  On a card, read its device marks (its logits have
        synchronised): from the part's start event to ``first`` (default:
        its step's first node) and from there to its step's last node,
        less a capture made since in the span it fell in (the device
        waited through it)."""
        spent = time.perf_counter() - t0
        capture = self.capture_seconds - captured
        if capture:
            self.timings["capture"].append(capture)
        timings = self.timings
        timings[part].append(spent - capture)
        timings[part + "_launch"].append(self._launch_s - capture)
        self._launch_s = 0.0
        if self._part_start is not None:
            marks = self._marks[part]
            mark = first or marks.first
            start = self._part_start.elapsed_time(mark) / 1e3
            device = mark.elapsed_time(marks.last) / 1e3
            # a capture precedes the step's own first node, and follows a
            # first event the part recorded before its step calls
            if first is None:
                start -= capture
            else:
                device -= capture
            timings[part + "_start"].append(start)
            timings[part + "_device"].append(device)

    def _note_experts(self, kind: str) -> None:
        """The experts the latest ``kind`` step touched, summed over its
        layers (moe only; read after the step's logits, outside the
        step's time)."""
        if self.expert_counts is not None:
            self.experts_touched[kind].append(
                int((self.expert_counts[kind] > 0).sum()))

    def _maybe_audit(self, level: int) -> None:
        """:meth:`audit` when ``ServeConfig.audit`` reaches ``level`` (1:
        after each step, 2: after each phase too)."""
        if self.scfg.audit < level:
            return
        t0 = time.perf_counter()
        try:
            self.audit()
        except AuditError:
            self.obs.on_audit(self.scfg.audit, False)
            raise
        self.timings["audit"].append(time.perf_counter() - t0)
        self.obs.on_audit(self.scfg.audit, True)

    def _apply_forks(self) -> None:
        """Run the page copies of the pending copy-on-write forks
        (mid-page cache hits admitted this step), in place on the current
        stream, before the prefill step reads or writes the pages."""
        for slot, src, dst in self.sched.pending_forks:
            fork_tail_page(self.pages, src, dst)
            owner = self.slot_req[slot]
            if owner is not None:
                self._charge_fork(owner.rid)
        self.sched.pending_forks.clear()

    def _prefill_once(self) -> None:
        """Advance every pending prompt by one batched chunk; a prompt
        whose prefill completes publishes its full pages to the prefix
        cache."""
        batch = self.sched.prefill_batch(audio_codebooks=self._codebooks)
        if batch is None:
            return
        tokens, pos0, seq_lens, lanes = batch
        t_obs = self.obs.now()
        t0, captured = self._start_part()
        with self.obs.annotate("serve.prefill_chunk"):
            self._load_lanes(block_tables=self.alloc.block_tables,
                             chunk_tokens=tokens, pos0=pos0,
                             seq_lens=seq_lens)
            with self.obs.annotate("serve.prefill_chunk.launch"):
                out = self._launch(self._prefill_paged)
            with self.obs.annotate("serve.prefill_chunk.wait"):
                lg = self._host_logits(out)
        self._timed("prefill", t0, captured)
        self._note_experts("prefill")
        self.obs.on_prefill([(slot, self.slot_req[slot].rid, n)
                             for slot, n in lanes], t_obs)
        self._charge_prefill([self.slot_req[slot].rid for slot, _ in lanes])
        fault_slot, lg = self._inject_lane_chaos([s for s, _ in lanes], lg)
        for slot, n_real in lanes:
            req = self.slot_req[slot]
            if slot == fault_slot:
                # a failed chunk on this lane: none of its bookkeeping
                # advances; retry or quarantine
                self._fault(slot, req, "step_fault")
                continue
            req.prefill_pos += n_real
            self.alloc.pos[slot] += n_real
            if req.prefill_pos >= len(req.prefill_tokens):
                last = lg[slot, -1]
                if not np.all(np.isfinite(last)):
                    # caught before the insert: poisoned pages are never
                    # published for other requests to share
                    self._fault(slot, req, "nan_logits")
                    continue
                req.last_logits = last
                if self.prefix_cache is not None:
                    # the prompt's full pages are written for good now
                    # (decode appends at positions past the prompt)
                    self.prefix_cache.insert(req.prefill_tokens,
                                             self.alloc.block_row(slot))

    def _decode_once_paged(self) -> None:
        lanes = self.sched.decode_lanes()
        # page grant first (may preempt): a preempted lane drops out of
        # this step and resumes via re-prefill with identical greedy state
        ready = []
        for slot, req in lanes:
            if len(req.output) >= req.max_new_tokens:
                continue
            if self.slot_req[slot] is not req:
                continue  # preempted by an earlier lane's grant
            if self.sched.grant_decode_page(slot):
                ready.append((slot, req))
        ready = [(s, r) for s, r in ready if self.slot_req[s] is r]
        if not ready:
            return
        self.sched.charge_decode(ready)
        tnow = self._clock()
        tokens = self._lane_tokens({slot: self._emit(req, tnow)
                                    for slot, req in ready})
        t_obs = self.obs.now()
        t0, captured = self._start_part()
        with self.obs.annotate("serve.decode_step"):
            self._load_lanes(
                block_tables=self.alloc.block_tables, pos=self.alloc.pos,
                active=self.sched.lane_mask(s for s, _ in ready),
                tokens=tokens)
            with self.obs.annotate("serve.decode_step.launch"):
                out = self._launch(self._decode_paged)
            with self.obs.annotate("serve.decode_step.wait"):
                lg = self._host_logits(out)
        self._timed("decode", t0, captured)
        self._note_experts("decode")
        self.obs.on_decode([(s, r.rid) for s, r in ready], t_obs)
        self._charge_decode([r.rid for _, r in ready])
        fault_slot, lg = self._inject_lane_chaos([s for s, _ in ready], lg)
        for slot, req in ready:
            if slot == fault_slot:
                self._fault(slot, req, "step_fault")
                continue
            last = lg[slot, -1]
            if not np.all(np.isfinite(last)):
                # the token appended above came from valid logits and its
                # K/V write landed; the recompute retry replays it, so the
                # greedy tokens are unchanged: only these logits are lost
                self._fault(slot, req, "nan_logits")
                continue
            self.alloc.pos[slot] += 1
            req.last_logits = last

    # ----------------------------------------------- faults / quarantine
    def _inject_lane_chaos(self, slots: List[int], lg: np.ndarray):
        """Consult the chaos injector after a step landed: returns
        ``(fault_slot, lg)``, where ``fault_slot`` (or None) takes a
        simulated step failure and ``lg`` may have one lane's logits
        overwritten with NaN (in a copy), which then meets the same
        finiteness check a real fault would."""
        if self.chaos is None or not slots:
            return None, lg
        fault_slot = None
        if self.chaos.fire("step_fault"):
            fault_slot = slots[self.chaos.pick("step_fault", len(slots))]
        if self.chaos.fire("nan_logits"):
            victim = slots[self.chaos.pick("nan_logits", len(slots))]
            lg = np.array(lg)
            lg[victim] = np.nan
        return fault_slot, lg

    def _scrub_slot_pages(self, slot: int) -> None:
        """Zero a faulted lane's private pages before they return to the
        free list (:func:`~repro_torch.serve.pages.scrub_pages`: in place,
        no host sync).  Pages the prefix cache holds or other lanes share
        are skipped: a clean prefill wrote them before this request's
        fault and other requests still read them.  On a data-sharded pool
        only the lane's own data shard holds them, at local page ids."""
        cached = (set(self.prefix_cache.pages())
                  if self.prefix_cache is not None else set())
        private = [p for p in self.alloc._mapped[slot]
                   if self.alloc.refcount[p] == 1 and p not in cached]
        if private and self._lane_shard is not None:
            if self.alloc.shard_of(slot) != self._lane_shard:
                return
            base = self._lane_shard * self.alloc.shard_pages
            private = [p - base for p in private]
        if private:
            scrub_pages(self.pages, private)

    def _fault(self, slot: int, req: Request, kind: str) -> None:
        """One lane's step failed (a simulated step failure or non-finite
        logits).  Within its request's retry budget the request is
        requeued at the head, recompute-style, exactly as a preemption
        (greedy tokens are kept); past it, it is quarantined with
        ``finish_reason="error"``.  Every other lane is untouched."""
        self.obs.on_fault(req.rid, kind)
        pol = self._retry.get(req.rid)
        if pol is None:
            pol = self._retry[req.rid] = RestartPolicy(
                max_restarts=self.scfg.max_request_retries, backoff_s=0.0,
                reset_after_steps=self.scfg.retry_reset_steps)
        try:
            pol.on_failure(RuntimeError(kind), self._engine_step)
        except RuntimeError:
            self._quarantine(slot, req, kind)
            return
        self._scrub_slot_pages(slot)
        self.sched.drop_forks(slot)
        self.alloc.free_slot(slot)
        self.slot_req[slot] = None
        req.prefill_tokens = list(req.prompt) + list(req.output)
        req.prefill_pos = 0
        req.cached_tokens = 0
        req.last_logits = None
        req.retries += 1
        self.retried += 1
        self.queue.appendleft(req)
        self.obs.on_retry(req.rid, kind, pol.restarts)

    def _quarantine(self, slot: int, req: Request, kind: str) -> None:
        """Remove a request whose retry budget is spent: its pages are
        scrubbed and released, its pending forks dropped, and it ends with
        ``finish_reason="error"``; tokens generated so far stay on
        ``req.output``."""
        req.cancelled = True
        req.finish_reason = "error"
        self._scrub_slot_pages(slot)
        self.sched.drop_forks(slot)
        self.alloc.free_slot(slot)
        self.slot_req[slot] = None
        self._retry.pop(req.rid, None)
        self.quarantined += 1
        self._errored_step.append(req)  # step() returns terminals
        self.obs.on_quarantine(req.rid, kind, len(req.output))

    # ------------------------------------------------------ slots internals
    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                self.slot_req[slot] = req
                self.obs.on_admit(req.rid, slot, 0)
                self._reset_slot(slot)
                self._prefill_slot(slot, req)

    def _reset_slot(self, slot: int) -> None:
        """Clear a slot's cache state before reuse: ``pos`` and the
        read-modify-write recurrent states (``conv`` / ``h``).  Stale K/V
        at positions up to ``pos`` is always overwritten before it is
        read, and positions beyond it are masked."""
        lane = self._local_lane(slot)
        if lane is None:
            return
        self.cache["pos"][lane] = 0
        for name in ("conv", "h"):
            if name in self.cache:
                self.cache[name][:, lane] = 0

    def _prefill_slot(self, slot: int, req: Request) -> None:
        """Prompt tokens enter the slot's cache by sequential decode, one
        slot at a time, as in the JAX package: one step a token with only
        this slot active, every other slot frozen.  The tokens reach the
        step's buffer by a copy on the device, so the loop never waits on
        the host until the last logits are read."""
        t_obs = self.obs.now()
        t0, captured = self._start_part()
        with self.obs.annotate("serve.prefill_slot"):
            prompt = torch.from_numpy(np.asarray(req.prompt, np.int32)).to(
                self.device)
            self._load_lanes(tokens=self._lane_tokens({}),
                             active=self._lane_mask([slot]))
            lane = self._local_lane(slot)
            logits = None
            if self._part_first is not None:
                self._part_first.record(self._current_stream())
            with self.obs.annotate("serve.prefill_slot.launch"):
                for i in range(len(req.prompt)):
                    if lane is not None:
                        self.lanes.tokens[lane].copy_(prompt[i:i + 1])
                    logits = self._launch(self._slots_step)
            with self.obs.annotate("serve.prefill_slot.wait"):
                req.last_logits = self._host_logits(logits)[slot, -1]
        self._timed("prefill", t0, captured, self._part_first)
        self.obs.on_prefill([(slot, req.rid, len(req.prompt))], t_obs)

    def _decode_one(self) -> None:
        updates: Dict[int, int] = {}
        tnow = self._clock()
        for slot, req in enumerate(self.slot_req):
            if req is None or req.last_logits is None:
                continue
            if len(req.output) >= req.max_new_tokens:
                continue
            updates[slot] = self._emit(req, tnow)
        if not updates:
            return
        tokens = self._lane_tokens(updates)
        t_obs = self.obs.now()
        t0, captured = self._start_part()
        with self.obs.annotate("serve.decode_step"):
            self._load_lanes(tokens=tokens, active=self._lane_mask(updates))
            with self.obs.annotate("serve.decode_step.launch"):
                out = self._launch(self._slots_step)
            with self.obs.annotate("serve.decode_step.wait"):
                lg = self._host_logits(out)
        self._timed("decode", t0, captured)
        self.obs.on_decode([(s, self.slot_req[s].rid) for s in updates],
                           t_obs)
        for slot in updates:
            self.slot_req[slot].last_logits = lg[slot, -1]

    # ------------------------------------------------------------- shared
    def _lane_tokens(self, updates: Dict[int, int]) -> np.ndarray:
        """A step's tokens, ``(n_slots, 1)`` (``(n_slots, 1, K)`` for the
        audio family, each id broadcast over the codebooks): ``updates``
        maps a lane to its token, the other lanes hold 0."""
        tokens = np.zeros((self.n_slots,) + tuple(self.lanes.tokens.shape[1:]),
                          np.int32)
        for slot, tok in updates.items():
            tokens[slot, 0] = tok
        return tokens

    def _lane_mask(self, slots: Iterable[int]) -> np.ndarray:
        mask = np.zeros((self.n_slots,), bool)
        mask[list(slots)] = True
        return mask

    def _retire(self, limit_only: bool = False) -> List[Request]:
        done = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self._should_retire(req, limit_only):
                req.done = True
                req.finish_reason = "length"
                done.append(req)
                if self.mode == "paged":
                    self.sched.drop_forks(slot)
                    self.alloc.free_slot(slot)
                self.slot_req[slot] = None
                self._retry.pop(req.rid, None)
                self.obs.on_retire(req.rid, "length", len(req.output))
        return done

    def _sample_next(self, req: Request) -> int:
        """The next token from a request's last logits: ``(V,)``, or ``(K,
        V)`` for the audio family, whose token stream carries one id
        broadcast over the codebooks, so codebook 0 is sampled (as in the
        JAX package)."""
        last = torch.from_numpy(np.asarray(req.last_logits))
        if last.ndim == 1:
            last = last[None]
        return int(sample(last, self.generator, self.scfg.temperature,
                          self.scfg.top_k)[0])

    def _emit(self, req: Request, tnow: float) -> int:
        """Sample ``req``'s next token and append it; the first one sets
        the request's time to first token."""
        tok = self._sample_next(req)
        if not req.output and req.ttft is None:
            req.ttft = tnow - req.submit_t
            self.obs.on_first_token(req.rid, req.ttft, tnow)
        else:
            self.obs.on_token(req.rid, tnow)
        req.output.append(tok)
        return tok

    def _should_retire(self, req: Request, limit_only: bool) -> bool:
        limit = len(req.output) >= req.max_new_tokens
        if limit_only:
            return limit
        overflow = len(req.prompt) + len(req.output) >= self.max_len - 1
        return limit or overflow
