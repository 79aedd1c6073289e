from repro_torch.serve.engine import AdmissionRejected, Request, ServeEngine
from repro_torch.serve.pages import (
    NULL_PAGE,
    AuditError,
    KVPages,
    LaneTables,
    PageAllocator,
    init_kv_pages,
    pages_for,
)
from repro_torch.serve.sampler import sample
from repro_torch.serve.scheduler import PagedScheduler
from repro_torch.serve.step_graph import StepGraph

__all__ = [
    "AdmissionRejected",
    "AuditError",
    "KVPages",
    "LaneTables",
    "NULL_PAGE",
    "PageAllocator",
    "PagedScheduler",
    "Request",
    "ServeEngine",
    "StepGraph",
    "init_kv_pages",
    "pages_for",
    "sample",
]
