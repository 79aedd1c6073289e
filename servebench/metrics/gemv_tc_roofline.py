"""The GEMV's tensor-core route against its roofline over the traced span,
in %: the sum of each tensor-core launch's bound (``costs.bound_s`` at M =
lanes x chunk: every layer linear of a chunk step) over the sum of the
route's kernel seconds (the tile and its split-K reduction) in the
profiler's trace."""

from servebench.metrics import _route


def read(run):
    return _route.share(run, "tensor_core")
