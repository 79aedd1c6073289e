from repro_torch.serve.engine import AdmissionRejected, Request, ServeEngine
from repro_torch.serve.pages import (
    NULL_PAGE,
    AuditError,
    KVPages,
    PageAllocator,
    init_kv_pages,
    pages_for,
)
from repro_torch.serve.sampler import sample
from repro_torch.serve.scheduler import PagedScheduler

__all__ = [
    "AdmissionRejected",
    "AuditError",
    "KVPages",
    "NULL_PAGE",
    "PageAllocator",
    "PagedScheduler",
    "Request",
    "ServeEngine",
    "init_kv_pages",
    "pages_for",
    "sample",
]
