"""The traced span of a ``--trace 1`` run: a fixed number of steps under
``torch.profiler`` after the measured window, and its summary.

The span starts at the first step after the window at which a lane is
prefilling (so that it holds chunk steps and decode steps alike), waits
at most ``wait_steps`` steps for one, and lasts ``steps`` steps.  The
summary keeps the device's busy seconds (the union of the intervals in
which an operation ran on the card) over the span's length, the device
seconds of each operation by name, the longest idle gaps named by the
host operation that was running in each, and the seconds and launches of
the GEMV's two routes, over the span and a step at a time (each step is
a window of its own that closes after a synchronize, so its kernels can
be told from the next step's).  Kernel names are read as ``chip_smoke.py``'s
``kernel_label`` reads them.
"""

from __future__ import annotations

import bisect
from typing import Dict

PREFIX = "servebench."
SPAN = PREFIX + "span"
STEP = PREFIX + "step."

# the bit-plane GEMV's kernels by route, by the labels' prefixes
ROUTE_KERNELS = {"decode": ("dec::decode_",),
                 "tensor_core": ("tc::tc_gemm_kernel", "tc::tc_reduce_kernel")}
# the kernel that counts one launch of each route
ROUTE_LAUNCH = {"decode": "dec::decode_", "tensor_core": "tc::tc_gemm_kernel"}
TOP = 10


def kernel_label(name: str) -> str:
    """A profiler kernel name without its namespace, return type and
    arguments: ``dec::decode_mma_kernel<4, 16, false>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0]


def route_of(label: str):
    for route, prefixes in ROUTE_KERNELS.items():
        if label.startswith(prefixes):
            return route
    return None


def _merge(spans):
    merged = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _route_stats():
    return {r: {"seconds": 0.0, "launches": 0} for r in ROUTE_KERNELS}


def summarize(events) -> Dict:
    """The span's summary from the profiler's events (``prof.events()``),
    times in seconds.  Empty when the span or its device operations are
    missing.  ``step_routes`` gives the GEMV routes' seconds and launches
    a step, from the device operations inside each step's window."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    span = [e for e in cpu if e.name == SPAN]
    if not span:
        return {}
    lo_w, hi_w = span[0].time_range.start, span[0].time_range.end
    # the harness's own annotations show on the device too: they are no
    # operations
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith(PREFIX)
              and lo_w <= e.time_range.start and e.time_range.end <= hi_w
              and e.time_range.end > e.time_range.start]
    if not device:
        return {}
    windows = sorted((e.time_range.start, e.time_range.end) for e in cpu
                     if e.name.startswith(STEP))
    starts = [w[0] for w in windows]
    step_routes = [_route_stats() for _ in windows]
    by_name: Dict[str, float] = {}
    routes = _route_stats()
    for e in device:
        label = kernel_label(e.name)
        dur = (e.time_range.end - e.time_range.start) / 1e6
        by_name[label] = by_name.get(label, 0.0) + dur
        route = route_of(label)
        if route is None:
            continue
        launch = label.startswith(ROUTE_LAUNCH[route])
        routes[route]["seconds"] += dur
        routes[route]["launches"] += launch
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.end <= windows[i][1]:
            step_routes[i][route]["seconds"] += dur
            step_routes[i][route]["launches"] += launch
    merged = _merge((e.time_range.start, e.time_range.end) for e in device)
    busy = sum(hi - lo for lo, hi in merged) / 1e6
    edges = [lo_w] + [x for iv in merged for x in iv] + [hi_w]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in cpu if not e.name.startswith(PREFIX)
                   and lo_w <= e.time_range.start <= hi_w),
                  key=lambda t: t[0])
    host_starts = [c[0] for c in host]
    idle = []
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (lo + hi) / 2
        name, width = "python", None
        for c in host[:bisect.bisect_right(host_starts, mid)][-400:]:
            if c[1] >= mid and (width is None or c[1] - c[0] < width):
                name, width = c[2], c[1] - c[0]
        idle.append([name, (hi - lo) / 1e6])
    return {
        "window_s": (hi_w - lo_w) / 1e6,
        "busy_s": busy,
        "device_ops": [[n, s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": idle,
        "routes": routes,
        "step_routes": step_routes,
        "device_op_count": len(device),
    }


def trace_span(client, spec: Dict) -> Dict:
    """Run the traced span on ``client`` (see the module docstring) and
    return the summary with the span's step records (``steps``) and the
    GEMV launches counted by the port over it (``counted``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import _build

    eng = client.eng
    for _ in range(spec.get("wait_steps", 200)):
        if any(r is not None and r.prefill_pos < len(r.prefill_tokens)
               for r in eng.slot_req):
            break
        client.step()
    before = dict(_build.ROUTE_LAUNCHES)
    first = len(client.steps)
    on_card = eng.device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(SPAN):
            for i in range(spec["steps"]):
                # a window a step, closed once the device is done with it
                with record_function(f"{STEP}{i}"):
                    client.step()
                    if on_card:
                        torch.cuda.synchronize()
    out = summarize(prof.events())
    out["steps"] = client.steps[first:]
    out["counted"] = {name: n - before[name]
                      for name, n in _build.ROUTE_LAUNCHES.items()
                      if name.startswith("bitplane_gemv/")}
    return out
