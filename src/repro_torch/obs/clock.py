"""The serve-path clock: the timebase of every request timestamp.

Everything under ``repro_torch.serve`` that stamps a request (``submit_t``,
TTFT, the front end's deadlines) reads time through :func:`now`, or
through an injected callable defaulting to it, so a test can inject a
manual clock and time moves only when it says so.
"""

from __future__ import annotations

import time


def now() -> float:
    """Monotonic seconds (the process-wide serve-path timebase)."""
    return time.perf_counter()


def sleep(seconds: float) -> None:
    """The one sleep on timed paths, beside the one clock."""
    if seconds > 0:
        time.sleep(seconds)
