"""Serving: paged-KV continuous batching (pages, prefix cache, schedulers,
engine) and the streaming front end over it."""

from repro_torch.serve.engine import AdmissionRejected, Request, ServeEngine
from repro_torch.serve.frontend import ServeFrontend, TokenStream
from repro_torch.serve.pages import (
    NULL_PAGE,
    AuditError,
    KVPages,
    LaneTables,
    PageAllocator,
    ShardedPageAllocator,
    fork_tail_page,
    init_kv_pages,
    pages_for,
)
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.sampler import sample
from repro_torch.serve.scheduler import (
    PRIORITY_WEIGHTS,
    BudgetScheduler,
    PagedScheduler,
)
from repro_torch.serve.step_graph import SegmentedStepGraph, StepGraph

__all__ = [
    "AdmissionRejected",
    "AuditError",
    "BudgetScheduler",
    "KVPages",
    "LaneTables",
    "NULL_PAGE",
    "PRIORITY_WEIGHTS",
    "PageAllocator",
    "PagedScheduler",
    "PrefixCache",
    "Request",
    "SegmentedStepGraph",
    "ServeEngine",
    "ServeFrontend",
    "ShardedPageAllocator",
    "StepGraph",
    "TokenStream",
    "fork_tail_page",
    "init_kv_pages",
    "pages_for",
    "sample",
]
