"""A serving step replayed as a captured CUDA graph.

The JAX package compiles each fixed-shape serving step whole: paged mode
jits ``_dec`` and ``_pf`` with the page pool donated, slots mode jits
``_step`` (``repro/serve/engine.py``).  The port's counterpart is a CUDA
graph (``torch.cuda.graphs``): the step's kernels, the hand-written ones
and PyTorch's own, are captured once and replayed with one launch, so the
host no longer issues them one by one.

A graph replays fixed addresses, so a step function wrapped here reads
only tensors whose storage never changes: the parameters, the page pool
or slots cache (written in place by the model functions) and the
engine's static lane buffers (``serve/pages.py`` ``LaneTables``), which
the engine fills with ``copy_`` before each call.  None of them may be
rebound after the capture.

The launch counters of ``kernels/_build.py`` run in Python, so only the
capture would count: the capture's counts are taken back out and added
again on every replay (``_build.recording`` / ``add_launches``).
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.kernels import _build


class StepGraph:
    """``fn()``, a step at fixed shapes, as a replayed CUDA graph.

    The first call runs ``fn`` eagerly and is the real step: it builds the
    kernels and sets each launcher's one-time shared-memory attribute
    outside any capture.  The second call captures ``fn`` on a side stream
    (``torch.cuda.graph``, into ``pool`` when given: graphs replayed one
    at a time on one stream may share one) and replays it; every later
    call replays.  What ``fn`` returned at the capture is returned by
    every replay, overwritten by the next one: read it before calling
    again.

    A capture that fails raises; the step never falls back to eager.
    ``capture_seconds`` is the host time the capture took.

    The garbage collector is held off during the capture: a dead engine's
    graphs, freed by a collection in the middle of this capture, would
    invalidate it (tearing a graph down is not permitted while a stream
    captures).  They are freed at a later collection instead.
    """

    def __init__(self, fn: Callable[[], Any], *, pool=None):
        self.fn = fn
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output: Any = None
        self.launches: Dict[str, int] = {}   # counted by one replay
        self.calls = 0
        self.capture_seconds = 0.0

    def __call__(self) -> Any:
        self.calls += 1
        if self.calls == 1:
            return self.fn()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        _build.add_launches(self.launches)
        return self.output

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _build.recording() as launches:
                with torch.cuda.graph(graph, pool=self.pool):
                    output = self.fn()
        finally:
            if collecting:
                gc.enable()
        self.graph, self.output, self.launches = graph, output, launches
        self.capture_seconds = time.perf_counter() - t0
