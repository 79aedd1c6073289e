"""The 99th percentile of every inter-token gap in the window, in ms."""

from servebench.window import percentile


def read(run):
    gaps = run.gaps()
    return 1e3 * percentile(gaps, 99) if gaps else None
