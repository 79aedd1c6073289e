"""Mean host ms a window's step spends outside its parts: each
``ServeEngine.step()``'s seconds (``timings["step"]``) less its prefill
chunk's and decode step's (``timings["prefill"]`` / ``["decode"]``), that
is admission, copy-on-write forks, page grants, sampling and emission,
and retirement.  Read only where the engine kept device readings (on a
card), as ``graph_idle_share``."""

from servebench.metrics.graph_idle_share import window_parts


def read(run):
    parts = window_parts(run)
    if parts is None:
        return None
    outside = (sum(parts["step"]) - sum(parts["prefill"])
               - sum(parts["decode"]))
    return 1e3 * outside / len(parts["step"])
