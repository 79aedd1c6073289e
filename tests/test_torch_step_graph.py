"""The pieces around the serving steps' CUDA graphs that run on the CPU.

* ``StepGraph`` (``serve/step_graph.py``) with a stand-in for
  ``torch.cuda.CUDAGraph`` / ``torch.cuda.graph``: the first call runs the
  step eagerly and counts its launches; the capture's launches are taken
  back out of ``_build.LAUNCHES`` / ``ROUTE_LAUNCHES``; every replay adds
  them again, so N calls count what N eager steps count.  A capture that
  fails raises and leaves the counts as they were.
* ``LaneTables`` (``serve/pages.py``): the engine's persistent lane
  buffers hold the same tables as the JAX-shaped
  ``PageAllocator.device_tables`` and keep their storage across loads.

The card tests (``test_torch_cuda_kernels.py``, ``-k graph``) replay real
graphs against eager steps.
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.serve import LaneTables, PageAllocator, StepGraph


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: replays do nothing but
    count, as a real replay runs no Python."""

    made = []

    def __init__(self):
        self.captured = False
        self.replays = 0
        FakeGraph.made.append(self)

    def replay(self):
        assert self.captured
        self.replays += 1


@contextlib.contextmanager
def fake_capture(graph, pool=None):
    yield
    graph.captured = True


@pytest.fixture
def counts(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(_build, "ROUTE_LAUNCHES", dict(_build.ROUTE_LAUNCHES))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    FakeGraph.made = []
    _build.reset_launches()
    return _build


def _decode_like_step(runs):
    """Counts as a decode step of two layers: four GEMVs on the decode
    route and two paged decode attentions."""
    def step():
        runs.append(1)
        for _ in range(2):
            _build.count("bitplane_gemv", "decode")
            _build.count("bitplane_gemv", "decode")
            _build.count("paged_decode_attention")
        return torch.full((2,), float(len(runs)))
    return step


@pytest.mark.parametrize("calls", [1, 2, 3, 7])
def test_replays_count_what_eager_steps_count(counts, calls):
    runs = []
    graph = StepGraph(_decode_like_step(runs))
    outs = [graph() for _ in range(calls)]
    # the step's Python ran for the eager call and for the capture only
    assert len(runs) == min(calls, 2)
    assert counts.LAUNCHES["bitplane_gemv"] == 4 * calls
    assert counts.ROUTE_LAUNCHES["bitplane_gemv/decode"] == 4 * calls
    assert counts.LAUNCHES["paged_decode_attention"] == 2 * calls
    assert sum(counts.LAUNCHES.values()) == 6 * calls
    assert sum(counts.ROUTE_LAUNCHES.values()) == 4 * calls
    if calls > 1:
        (fake,) = FakeGraph.made
        assert fake.replays == calls - 1
        assert graph.launches == {"bitplane_gemv": 4,
                                  "bitplane_gemv/decode": 4,
                                  "paged_decode_attention": 2}
        # every replay hands back the tensor the capture produced
        assert all(o is graph.output for o in outs[1:])
        assert graph.capture_seconds > 0
    else:
        assert graph.graph is None and FakeGraph.made == []


def test_failed_capture_raises_and_counts_nothing(counts):
    state = {"calls": 0}

    def step():
        state["calls"] += 1
        _build.count("bitplane_gemv", "tensor_core")
        if state["calls"] == 2:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return torch.zeros(1)

    graph = StepGraph(step)
    graph()
    with pytest.raises(RuntimeError, match="capturing"):
        graph()
    assert graph.graph is None
    assert counts.LAUNCHES["bitplane_gemv"] == 1
    assert counts.ROUTE_LAUNCHES["bitplane_gemv/tensor_core"] == 1


def test_recording_hands_over_the_delta(counts):
    counts.count("ssd_scan")
    with counts.recording() as delta:
        counts.count("flash_attention", "tensor_core")
        counts.count("flash_attention", "tensor_core")
    assert delta == {"flash_attention": 2, "flash_attention/tensor_core": 2}
    assert counts.LAUNCHES["flash_attention"] == 0
    assert counts.LAUNCHES["ssd_scan"] == 1
    counts.add_launches(delta)
    counts.add_launches(delta)
    assert counts.LAUNCHES["flash_attention"] == 4
    assert counts.ROUTE_LAUNCHES["flash_attention/tensor_core"] == 4
    assert counts.ROUTE_LAUNCHES["flash_attention/cuda_core"] == 0


@pytest.mark.parametrize("page_size,max_len", [(4, 32), (16, 100)])
def test_lane_tables_hold_the_device_tables(page_size, max_len):
    n_slots = 3
    alloc = PageAllocator(40, page_size, n_slots, max_len)
    lanes = LaneTables(n_slots, "cpu", max_blocks=alloc.max_blocks, chunk=5)
    ptrs = {name: getattr(lanes, name).data_ptr()
            for name in ("block_tables", "pos", "tokens", "active",
                         "chunk_tokens", "pos0", "seq_lens")}
    rng = np.random.default_rng(0)
    for step in range(4):
        slot = step % n_slots
        if step == 3:
            alloc.free_slot(0)
        else:
            assert alloc.ensure(slot, int(rng.integers(1, max_len)))
            alloc.pos[slot] = rng.integers(0, page_size)
        lanes.load_tables(alloc)
        bt, pos = alloc.device_tables("cpu")
        assert torch.equal(lanes.block_tables, bt)
        assert torch.equal(lanes.pos, pos)
        assert lanes.block_tables.dtype == bt.dtype == torch.int32
        tokens = rng.integers(0, 100, (n_slots, 1)).astype(np.int32)
        active = rng.integers(0, 2, n_slots).astype(bool)
        chunk = rng.integers(0, 100, (n_slots, 5)).astype(np.int32)
        lanes.load(tokens=tokens, active=active, chunk_tokens=chunk,
                   pos0=alloc.pos, seq_lens=alloc.pos + 5)
        assert torch.equal(lanes.tokens, torch.from_numpy(tokens))
        assert torch.equal(lanes.active, torch.from_numpy(active))
        assert torch.equal(lanes.chunk_tokens, torch.from_numpy(chunk))
        assert torch.equal(lanes.seq_lens, torch.from_numpy(alloc.pos + 5))
        # the buffers keep their storage: a graph reads them in place
        assert {name: getattr(lanes, name).data_ptr()
                for name in ptrs} == ptrs


def test_slots_lane_tables_have_no_paged_buffers():
    lanes = LaneTables(2, "cpu")
    assert lanes.tokens.shape == (2, 1) and lanes.active.dtype == torch.bool
    assert not hasattr(lanes, "block_tables")
    assert not hasattr(lanes, "chunk_tokens")


@pytest.mark.parametrize("fails", [False, True])
def test_capture_holds_the_collector_off(counts, fails):
    """A dead engine's graphs collected in the middle of a capture would
    invalidate it on the card: the collector is off during the capture
    and on again after it, a failed one too."""
    import gc

    during = []

    def step():
        if graph.calls > 1:                   # the capture
            during.append(gc.isenabled())
            if fails:
                raise RuntimeError("capture failed")
        return torch.zeros(1)

    graph = StepGraph(step)
    graph()                                   # eager
    assert gc.isenabled()
    if fails:
        with pytest.raises(RuntimeError, match="capture failed"):
            graph()
    else:
        graph()
    assert during == [False]
    assert gc.isenabled()
