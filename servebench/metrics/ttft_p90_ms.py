"""The 90th percentile of time to first token over every request due in the
window, from its due time, in ms; a request that failed or had no first
token by the window's end counts as missing (infinitely late)."""

import math

from servebench.window import percentile


def read(run):
    ttfts = run.ttfts()
    if not ttfts:
        return None
    p90 = percentile(ttfts, 90)
    return 1e3 * p90 if math.isfinite(p90) else None
