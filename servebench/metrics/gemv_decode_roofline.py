"""The GEMV's decode route against its roofline over the traced span, in %:
the sum of each decode-route launch's bound (``costs.bound_s`` at M =
lanes: every linear of a decode step, and the head of a chunk step) over
the sum of the route's kernel seconds in the profiler's trace."""

from servebench.metrics import _route


def read(run):
    return _route.share(run, "decode")
