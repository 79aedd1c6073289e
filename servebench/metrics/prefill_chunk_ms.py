"""Mean host ms of the window's prefill chunk steps, each from its start to
the engine's sync on its logits (``ServeEngine.timings["prefill"]``)."""


def read(run):
    times = [s.chunk_s for s in run.steps if s.chunk]
    return 1e3 * sum(times) / len(times) if times else None
