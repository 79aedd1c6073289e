"""Share of the measured window in which the card ran none of the serving
steps, in %: 1 minus the device seconds of the window's parts (each
prefill chunk and decode step from its graph's first node to its last,
``ServeEngine.timings["prefill_device"]`` / ``["decode_device"]``, read
from timing events captured into the graph) over the window's seconds.
No profiler runs in the window.

``window_parts`` (shared with ``graph_start_ms`` and ``step_host_ms``)
finds the window's entries of the engine's lists by position: every
``Client.step`` runs one ``ServeEngine.step``, so the window's steps and
parts are counted back from the newest entry, past the steps that follow
the window (the wait for a prefilling lane and the traced span)."""

# (the engine's part, the step record's flag, the seconds it kept)
PARTS = (("prefill", "chunk", "chunk_s"), ("decode", "decode", "decode_s"))


def _before(values, n, after):
    """The ``n`` entries of ``values`` before its last ``after``; None
    where it has fewer."""
    end = len(values) - after
    return values[end - n:end] if end - n >= 0 else None


def window_parts(run):
    """``{key: the window's entries}`` of the engine's ``"step"`` and of
    each part's seconds, ``_launch``, ``_start`` and ``_device``; None
    where the engine kept no device readings (not on a card, or a
    program without them) or where the part seconds picked differ from
    those the client kept."""
    timings = run.client.eng.timings
    if not run.steps or not (timings.get("prefill_device")
                             or timings.get("decode_device")):
        return None
    steps = run.client.steps
    end = len(steps)
    while end and steps[end - 1] is not run.steps[-1]:
        end -= 1
    if not end:
        return None
    after = steps[end:]
    out = {"step": _before(timings["step"], len(run.steps), len(after))}
    for part, flag, kept in PARTS:
        keys = (part, part + "_launch", part + "_start", part + "_device")
        if len({len(timings[k]) for k in keys}) != 1:
            return None
        n = sum(getattr(s, flag) for s in run.steps)
        n_after = sum(getattr(s, flag) for s in after)
        for key in keys:
            out[key] = _before(timings[key], n, n_after)
        if out[part] != [getattr(s, kept) for s in run.steps
                         if getattr(s, flag)]:
            return None
    if out["step"] is None:
        return None
    return out


def read(run):
    parts = window_parts(run)
    if parts is None:
        return None
    device = sum(parts["prefill_device"]) + sum(parts["decode_device"])
    return 100.0 * (1.0 - device / run.seconds)
