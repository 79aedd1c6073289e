"""A mesh rank's serving step as CUDA graph segments, on the CPU.

``serve/step_graph.py`` ``SegmentedStepGraph`` captures a step cut at its
collectives (``dist/collectives.py`` ``cutting``) and replays the
segments in order with each collective run by the host between them.
Here ``torch.cuda``'s graph, stream and sync calls are stand-ins that log
what happens, and the collectives run on a stand-in group of n identical
ranks (a sum is n times the input, a gather n copies):

* a step with k collectives on groups of more than one rank is k + 1
  segments, replayed in order with the host collectives between them;
  a group of one cuts nothing;
* launches count once per replay, the segments' summed;
* a capture that fails in a middle segment raises, ends the open
  segment and leaves the counts as they were;
* no sync and no ``torch.distributed`` call happens while a segment is
  capturing; ``reduce_scatter`` and the ring permute raise there;
* the engine refuses graphs on NCCL only, naming ROADMAP queue 1 item
  8 (e).

On two ``gloo`` ranks (``test_torch_dist.run_ranks``): the host steps of
a captured step, run on the segments' buffers, equal ``all_reduce`` /
``all_gather`` called eagerly on the same inputs, bit for bit.

The card test (``test_torch_cuda_kernels.py -k mesh_graph``) serves a
reduced model on two ranks with graphs against eager.
"""

import contextlib
import functools

import pytest
import torch
import torch.distributed as dist

from repro_torch.dist import collectives
from repro_torch.kernels import _build
from repro_torch.serve import SegmentedStepGraph
from repro_torch.serve.engine import _check_mesh_options

from test_torch_dist import run_ranks

LOG = []


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: capture_begin / end and
    replay are logged (a real replay runs no Python)."""

    open = False
    made = 0

    def __init__(self):
        self.index = FakeGraph.made
        FakeGraph.made += 1

    def capture_begin(self, pool=None):
        assert not FakeGraph.open, "a capture inside a capture"
        FakeGraph.open = True
        LOG.append(("begin", self.index, pool))

    def capture_end(self):
        assert FakeGraph.open
        FakeGraph.open = False
        LOG.append(("end", self.index))

    def replay(self):
        assert not FakeGraph.open
        LOG.append(("replay", self.index))


class Group:
    """A stand-in process group of ``n`` identical ranks."""

    def __init__(self, n):
        self.n = n


def _sync():
    assert not FakeGraph.open, "a sync inside a capture"
    LOG.append(("sync",))


def _fake_all_reduce(t, op=None, group=None):
    assert not FakeGraph.open, "a collective inside a capture"
    LOG.append(("all_reduce", group.n))
    t.mul_(group.n)


def _fake_all_gather(out, x, group=None):
    assert not FakeGraph.open, "a collective inside a capture"
    LOG.append(("all_gather", group.n))
    out.copy_(torch.cat([x] * group.n))


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(_build, "ROUTE_LAUNCHES", dict(_build.ROUTE_LAUNCHES))
    _build.reset_launches()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(SegmentedStepGraph, "capture_stream", None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: object())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", _sync)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(dist, "all_reduce", _fake_all_reduce)
    monkeypatch.setattr(dist, "all_gather_into_tensor", _fake_all_gather)
    monkeypatch.setattr(collectives, "_group_size", lambda g: g.n)
    # the host side of every collective (its wait for the device
    # included) must run outside the capture
    timed = collectives._timed

    def checked(*args, **kw):
        assert not FakeGraph.open, "a host collective inside a capture"
        return timed(*args, **kw)

    monkeypatch.setattr(collectives, "_timed", checked)
    LOG.clear()
    FakeGraph.open = False
    FakeGraph.made = 0
    collectives.reset_seconds()
    yield _build
    assert not FakeGraph.open
    assert not collectives._CUTS


def _step(kinds, n=2, runs=None):
    """A step of ``kinds`` collectives (``"reduce"`` / ``"gather"``) on a
    group of ``n``, one GEMV launch before each and one after the last."""
    group = Group(n)
    x = torch.arange(4, dtype=torch.bfloat16)

    def step():
        if runs is not None:
            runs.append(1)
        h = x
        for kind in kinds:
            _build.count("bitplane_gemv", "decode")
            if kind == "reduce":
                h = collectives.all_reduce(h, group)
            else:
                h = collectives.all_gather(h, group)[:4]
        _build.count("bitplane_gemv", "decode")
        return h
    return step


def _events(kinds=("begin", "end", "replay", "all_reduce", "all_gather",
                   "sync")):
    return [e[:2] for e in LOG if e[0] in kinds]


@pytest.mark.parametrize("kinds", [(), ("reduce",), ("gather",),
                                   ("reduce", "gather"),
                                   ("reduce",) * 3 + ("gather", "reduce")],
                         ids=lambda k: "-".join(k) or "none")
def test_k_collectives_make_k_plus_1_segments(fake, kinds):
    runs = []
    graph = SegmentedStepGraph(_step(kinds, runs=runs), pool="engine")
    eager = graph()
    k = len(kinds)
    host = [("all_reduce" if kind == "reduce" else "all_gather", 2)
            for kind in kinds]
    # the first call is the eager step, with its collectives
    assert _events() == host and graph.graph is None
    LOG.clear()
    out = graph()
    assert graph.segments == k + 1 and len(graph.host_steps) == k
    # one sync before the first segment; the segments captured back to
    # back into the engine's pool; no collective while capturing
    begins = [e for e in LOG if e[0] == "begin"]
    assert [e[2] for e in begins] == ["engine"] * (k + 1)
    capture = [("sync",)] + [e for i in range(k + 1)
                             for e in (("begin", i), ("end", i))]
    replay = [e for i in range(k + 1) for e in (
        [("replay", i)] + ([host[i]] if i < k else []))]
    assert _events() == capture + replay
    LOG.clear()
    assert graph() is out
    assert _events() == replay
    assert len(runs) == 2   # eager and capture; replays run no Python
    assert out.shape == eager.shape and out.dtype == eager.dtype
    assert graph.capture_seconds > 0


def test_a_group_of_one_cuts_nothing(fake):
    graph = SegmentedStepGraph(_step(("reduce", "gather", "reduce"), n=1))
    graph()
    LOG.clear()
    graph()
    graph()
    assert graph.segments == 1 and graph.host_steps == []
    assert _events(("all_reduce", "all_gather")) == []
    assert _events(("replay",)) == [("replay", 0)] * 2
    # no engine pool given: the step's own, one for its segments
    assert [e[2] for e in LOG if e[0] == "begin"] == ["pool"]


@pytest.mark.parametrize("calls", [1, 2, 3, 6])
def test_launches_count_once_per_replay(fake, calls):
    graph = SegmentedStepGraph(_step(("reduce", "gather")))
    for _ in range(calls):
        graph()
    assert fake.ROUTE_LAUNCHES["bitplane_gemv/decode"] == 3 * calls
    assert fake.LAUNCHES["bitplane_gemv"] == 3 * calls
    if calls > 1:
        assert graph.launches == {"bitplane_gemv": 3,
                                  "bitplane_gemv/decode": 3}
        assert len(_events(("replay",))) == 3 * (calls - 1)


def test_failed_capture_in_a_middle_segment_raises(fake):
    group = Group(2)
    state = {"calls": 0}

    def step():
        state["calls"] += 1
        _build.count("bitplane_gemv", "tensor_core")
        h = collectives.all_reduce(torch.ones(3), group)
        _build.count("bitplane_gemv", "tensor_core")
        if state["calls"] == 2:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return collectives.all_reduce(h, group)

    graph = SegmentedStepGraph(step)
    graph()
    LOG.clear()
    with pytest.raises(RuntimeError, match="capturing"):
        graph()
    # the second segment was open when the step failed: ended, nothing
    # replayed, no collective run
    assert _events() == [("sync",), ("begin", 0), ("end", 0), ("begin", 1),
                         ("end", 1)]
    assert graph.graph is None and graph.segments == 0
    assert fake.LAUNCHES["bitplane_gemv"] == 2
    assert fake.ROUTE_LAUNCHES["bitplane_gemv/tensor_core"] == 2


def test_no_scatter_or_permute_inside_a_capture(fake):
    group = Group(2)
    for fn in (functools.partial(collectives.reduce_scatter, dim=0),
               functools.partial(collectives._permute, shift=1)):
        with pytest.raises(RuntimeError, match="segmented graph capture"):
            with collectives.cutting(lambda step: None):
                fn(torch.ones(4), group)
        assert not collectives._CUTS


def test_host_steps_report_their_seconds(fake):
    graph = SegmentedStepGraph(_step(("reduce", "reduce")))
    graph()
    graph()
    collectives.reset_seconds()
    graph()
    # each replay's host steps are timed as eager collectives are
    assert collectives.SECONDS[0] > 0 and collectives.WAIT[0] >= 0


def test_graphs_refused_on_nccl_only():
    for backend in (None, "gloo"):
        _check_mesh_options(True, backend)
    _check_mesh_options(False, "nccl")
    with pytest.raises(ValueError, match=r"ROADMAP.md queue 1 item 8 \(e\)"):
        _check_mesh_options(True, "nccl")


HOST_STEPS = """
import contextlib
from repro_torch.dist import collectives
from repro_torch.serve import SegmentedStepGraph


class FakeGraph:
    # on the CPU a capture runs its operations: the buffers a host step
    # reads hold what the segment before it wrote
    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


torch.cuda.CUDAGraph = FakeGraph
torch.cuda.Stream = lambda *a, **k: None
torch.cuda.stream = lambda s: contextlib.nullcontext()
torch.cuda.synchronize = lambda *a: None
torch.cuda.empty_cache = lambda: None
torch.cuda.graph_pool_handle = lambda: None

mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
group = mesh.group("model")
gen = torch.Generator().manual_seed(RANK)
xs = {"bf16": torch.randn((3, 40), generator=gen).bfloat16(),
      "f32": torch.randn((3, 40), generator=gen),
      "i32": torch.randint(-9, 9, (5,), generator=gen, dtype=torch.int32)}
out = {"eager": {}, "host": {}}
for name, x in xs.items():
    out["eager"][f"sum_{name}"] = collectives.all_reduce(x, group)
    out["eager"][f"gather_{name}"] = collectives.all_gather(x, group, dim=-1)
out["eager"]["max_f32"] = collectives.all_reduce(xs["f32"], group, op="max")


def step():
    for name, x in xs.items():
        collectives.all_reduce(x, group)
        collectives.all_gather(x, group, dim=-1)
    collectives.all_reduce(xs["f32"], group, op="max")


graph = SegmentedStepGraph(step)
graph()
graph()
out["segments"] = graph.segments
names = [f"{op}_{name}" for name in xs for op in ("sum", "gather")]
for name, host in zip(names + ["max_f32"], graph.host_steps):
    # partial(_timed, call, x, *call_args): the collective's output buffer
    buf = host.args[2]
    x = xs[name.split("_")[1]]
    if name.startswith("gather"):
        buf = buf.movedim(0, -1)
    out["host"][name] = buf.to(x.dtype)
put(out)
"""


def test_host_steps_equal_the_collectives_on_two_gloo_ranks(tmp_path):
    res = run_ranks(tmp_path, 2, HOST_STEPS, timeout=120)
    for r, out in enumerate(res):
        assert out["segments"] == 8
        assert set(out["host"]) == set(out["eager"])
        for name, want in out["eager"].items():
            got = out["host"][name]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, want), (r, name)
        assert torch.equal(out["eager"]["sum_i32"],
                           res[0]["eager"]["sum_i32"])
