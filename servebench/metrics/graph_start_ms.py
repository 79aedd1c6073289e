"""Mean device ms from a part's start to its graph's first node over the
window's prefill chunks and decode steps (``ServeEngine.timings
["prefill_start"]`` / ``["decode_start"]``: a timing event recorded on
the stream as the part starts, the stream idle since the last part's
logits sync, to the event captured as the graph's first node): the gap
that loading the lanes and launching the graph open before it runs."""

from servebench.metrics.graph_idle_share import window_parts


def read(run):
    parts = window_parts(run)
    if parts is None:
        return None
    starts = parts["prefill_start"] + parts["decode_start"]
    return 1e3 * sum(starts) / len(starts) if starts else None
