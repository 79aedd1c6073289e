"""Mean host ms of the window's decode steps, each from its start to the
engine's sync on its logits (``ServeEngine.timings["decode"]``)."""


def read(run):
    times = [s.decode_s for s in run.steps if s.decode]
    return 1e3 * sum(times) / len(times) if times else None
