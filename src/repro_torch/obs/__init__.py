"""Serve-path observability.  Only the clock is ported so far: the
timebase of ``Request.submit_t`` / ``ttft`` and the front end's
deadlines."""

from repro_torch.obs import clock

__all__ = ["clock"]
