"""Share of the window's chunk-step rows that were padding, in %: 1 minus
the prompt rows computed (``prefill_computed``) over ``lanes x chunk``
rows a chunk step."""


def read(run):
    chunks = [s for s in run.steps if s.chunk]
    if not chunks:
        return None
    rows = run.serve["lanes"] * run.serve["prefill_chunk"] * len(chunks)
    return 100.0 * (1.0 - sum(s.prefill_rows for s in chunks) / rows)
