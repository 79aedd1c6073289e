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

**On a mesh** (:class:`SegmentedStepGraph`) a step runs collectives, and
on ``gloo`` (ranks sharing one card) a collective is a host call that no
graph can hold.  The step is captured as graph segments cut at its
collectives instead (``dist/collectives.py`` ``cutting``): a step with k
collectives on groups of more than one rank is k + 1 graphs, and a
replay runs them in order with each collective between them, on the
host, on the buffer its segment wrote.  The segments of a step share one
memory pool (the engine's): a tensor one segment writes and a later one
reads lives at the address both captured, because graphs that share a
pool are safe when they replay in the order they were captured.  The
engine's steps never interleave: each step replays all its segments
before another step's first.  The host steps hold the collectives'
buffers, so they live as long as the graph.

**Device marks** (:class:`MarkedStep`): on a card the engine wraps each
step function in a pair of timing events recorded before and after it.
Captured, they are the graph's first and last nodes (on a mesh, the
first segment's first and the last segment's last), re-recorded by
every replay, so the host reads the replay's device span once the step's
logits have synchronised, with no sync of its own; run eagerly, they
bracket the step's kernels from outside.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.dist import collectives
from repro_torch.kernels import _build


class MarkedStep:
    """``fn()`` between two timing events, ``first`` and ``last``, made
    once (``external``: a capture records them as graph nodes)."""

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn
        self.first = torch.cuda.Event(enable_timing=True, external=True)
        self.last = torch.cuda.Event(enable_timing=True, external=True)

    def __call__(self) -> Any:
        self.first.record()
        out = self.fn()
        self.last.record()
        return out


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
        self._replay()
        _build.add_launches(self.launches)
        return self.output

    def _replay(self) -> None:
        self.graph.replay()

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


class SegmentedStepGraph(StepGraph):
    """``fn()``, a step of a mesh rank, as graph segments with its
    collectives run by the host between their replays (the module
    docstring).

    Calls go as :class:`StepGraph`'s: the first runs ``fn`` eagerly, with
    its collectives; the second captures every segment and replays them;
    later calls replay.  ``graph`` is then the list of segments and
    ``host_steps`` the collectives between them (``segments`` = ``len(
    host_steps) + 1``); ``launches`` sums the segments' launches, added
    once a replay.  The capture synchronises the device once, before its
    first segment, and nothing inside it does: the collectives run only
    at replay, each after waiting for its segment's device work.  A
    capture that fails, in any segment, raises with the counts as they
    were; the step never falls back to eager.
    """

    # the side stream every segment is captured on, made at the first
    # capture (one process a rank, one device), as ``torch.cuda.graph``
    # keeps its default capture stream
    capture_stream = None

    def __init__(self, fn: Callable[[], Any], *, pool=None):
        super().__init__(fn, pool=pool)
        self.host_steps: List[Callable[[], None]] = []

    @property
    def segments(self) -> int:
        """Graph segments a replay runs (0 before the capture)."""
        return 0 if self.graph is None else len(self.graph)

    def _replay(self) -> None:
        for graph, step in zip(self.graph, self.host_steps + [None]):
            graph.replay()
            if step is not None:
                step()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        pool = (self.pool if self.pool is not None
                else torch.cuda.graph_pool_handle())
        graphs: List[torch.cuda.CUDAGraph] = []
        steps: List[Callable[[], None]] = []
        open_ = [False]

        def begin():
            graph = torch.cuda.CUDAGraph()
            graphs.append(graph)
            graph.capture_begin(pool=pool)
            open_[0] = True

        def end():
            open_[0] = False
            graphs[-1].capture_end()

        def cut(host_step):
            end()
            steps.append(host_step)
            begin()

        # as torch.cuda.graph prepares a capture, once for all segments
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        if SegmentedStepGraph.capture_stream is None:
            SegmentedStepGraph.capture_stream = torch.cuda.Stream()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _build.recording() as launches, \
                    torch.cuda.stream(SegmentedStepGraph.capture_stream), \
                    collectives.cutting(cut):
                begin()
                try:
                    output = self.fn()
                except BaseException:
                    if open_[0]:
                        # end the broken capture; its own error is the
                        # one that matters
                        open_[0] = False
                        try:
                            graphs[-1].capture_end()
                        except RuntimeError:
                            pass
                    raise
                end()
        finally:
            if collecting:
                gc.enable()
        self.graph, self.host_steps = graphs, steps
        self.output, self.launches = output, launches
        self.capture_seconds = time.perf_counter() - t0
