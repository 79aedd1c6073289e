"""Per-op cost of an eager PyTorch program: the port's counterpart of the
JAX package's ``repro/roofline/hlo_cost.py``.

JAX compiles a cell to HLO and walks the text, multiplying each ``while``
body by its trip count.  The port has no compiled program: it **runs**
the cell, eagerly, on the device it is given (``meta`` for a dry run: a
rank's shapes and no memory), under :class:`OpCounter`, a
``TorchDispatchMode`` that sees every aten op as it executes.  A Python
loop is unrolled by running it, so nothing is multiplied by a trip count;
backward ops and remat's recomputation are counted as they run.

Each op is priced by ``hlo_cost``'s conventions:

* **FLOPs**: dots (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  convolution) at 2·|out|·|contraction|; arithmetic elementwise ops at 1 an
  output element and reductions at 1 an input element; transcendentals
  (``exp``, ``log``, ``tanh``, ``rsqrt``, ``sqrt``, ``pow``, ``sigmoid``,
  ``erf``, ``sin``, ``cos``, …) counted apart *and* into ``flops``;
  composite activations (softmax, SiLU, GELU) at the elementwise ops XLA
  lowers them to;
* views, ``empty`` and metadata ops are free;
* **bytes**: operands plus outputs of every op that is not free, each
  tensor at the distinct elements it spans (a broadcast operand at its
  own size); a scatter into a buffer in place (``index_put_`` and its
  kind) at twice its update plus its indices, a gather at twice its
  output plus its indices, as ``hlo_cost`` prices them.  Every eager op
  is a kernel boundary on the card, so this is the port's own memory
  model, not XLA's fused one: the two are not meant to agree.

**Regions.**  An op's cost also goes to the region of the first function
of :data:`REGION_TAGS` found on the Python stack (the port's functions
carry the JAX package's names).  No hook is added to model code.

**Priced calls.**  A hand-written kernel's wrapper opens :func:`priced`
with its bytes and operations from ``roofline.kernel_costs`` and the
route the card takes: while it is open, the ops beneath it are not
counted.  So a cell counts the same on ``cpu`` (the plain versions run
underneath), ``cuda`` (a ctypes launch the mode cannot see) and ``meta``
(the wrapper returns an empty output).  The collectives of
``dist.collectives`` tally their output bytes by JAX's family names
through :func:`collective`, the same way.

**Memory** (``memory_analysis``): ``argument_size_in_bytes`` and
``output_size_in_bytes``, the distinct storages of the arguments and of
the outputs; ``alias_size_in_bytes``, the argument storages that an op
writes in place (JAX's donated buffers); ``temp_size_in_bytes``, the peak
of the storages created while counting that are alive at once (storages,
not views, released through weakref finalizers).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# regions of interest: a function name on the stack -> tag (hlo_cost's)
REGION_TAGS = {
    "attend_flash": "attention",
    "attend_dense": "attention",
    "attend_local_gather": "attention",
    "attend_decode": "attention",
    "ssd_chunked": "ssd",
    "_ssm_run": "ssd",
    "moe_block": "moe",
    "chunked_ce": "ce",
    "_lm_logits": "ce",
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_unsafe_view", "lift_fresh", "set",
    "resize", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_local_scalar_dense", "is_nonzero", "size", "stride",
    "storage_offset", "dim", "numel", "_has_compatible_shallow_copy_type",
    "record_stream", "result_type", "scalar_tensor",
}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "addbmm",
         "_addmm_activation"}
_ELEMENTWISE_1FLOP = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
    "logical_not", "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "bitwise_left_shift", "bitwise_right_shift",
    "__and__", "__or__", "__xor__", "__lshift__", "__rshift__", "clamp",
    "clamp_min", "clamp_max", "remainder", "fmod", "floor", "ceil", "round",
    "trunc", "sign", "masked_fill", "reciprocal", "square", "fmax", "fmin",
    "floor_divide", "copysign", "isnan", "isinf", "isfinite", "nan_to_num",
    "relu", "threshold_backward", "hardtanh",
}
# (FLOPs, transcendentals) an output element
_COMPOSITE = {
    "addcmul": (2, 0), "addcdiv": (2, 0), "lerp": (2, 0),
    "silu": (2, 1), "silu_backward": (4, 1),
    "gelu": (9, 1), "gelu_backward": (14, 1),
    "softplus": (5, 2), "softplus_backward": (5, 1),
    "_softmax": (5, 1), "_log_softmax": (5, 1),
    "_softmax_backward_data": (3, 0), "_log_softmax_backward_data": (3, 1),
    "sigmoid_backward": (3, 0), "tanh_backward": (3, 0),
}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "rsqrt", "sqrt", "pow", "sigmoid", "erf", "erfc", "erfinv", "sin",
    "cos", "tan", "atan", "atan2", "asin", "acos", "sinh", "cosh",
}
# reductions: 1 FLOP an input element
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
           "argmax", "argmin", "cumsum", "cumprod", "logsumexp", "var",
           "std", "var_mean", "std_mean", "linalg_vector_norm", "norm",
           "sort", "topk", "argsort", "aminmax", "count_nonzero"}
# in-place scatters: twice the update plus the indices (hlo_cost's
# dynamic-update-slice / scatter), index of the update argument
_SCATTER_INPLACE = {"index_put": 2, "_index_put_impl": 2, "index_copy": 3,
                    "index_add": 3, "scatter": 3, "scatter_add": 3,
                    "scatter_reduce": 3, "masked_scatter": 2}
_GATHER = {"index", "index_select", "gather", "embedding", "take",
           "masked_select"}
_WRITE_ONLY = {"zero", "fill", "zeros", "ones", "full", "zeros_like",
               "ones_like", "full_like", "arange", "scalar_tensor",
               "randn", "rand", "randint", "randperm", "normal", "uniform",
               "bernoulli", "linspace", "eye", "tensor"}


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


def _is_inplace(func) -> bool:
    name = func.overloadpacket.__name__
    return name.endswith("_") and not name.endswith("__")


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _span_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` spans: a broadcast (stride 0)
    dimension counts once."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _numel(t: Optional[torch.Tensor]) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """Counts the ops run inside it (module docstring).  Read the totals
    from :meth:`result` after the block; ``track_args`` (the cell's
    arguments) set what counts as an argument for the memory figures."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {c: 0.0 for c in COLLECTIVES}
        self.regions: Dict[str, List[float]] = {}
        self.priced: Dict[str, int] = {}
        self._suspended = 0
        self._arg_keys: Dict[Any, int] = {}
        self._aliased: Dict[Any, int] = {}
        self._live: Dict[Any, List[int]] = {}
        self._live_bytes = 0
        self.peak_bytes = 0
        self.output_bytes = 0

    # ------------------------------------------------------------ memory
    def track_args(self, *args, **kwargs) -> None:
        for t in _tensors((args, kwargs)):
            st = t.untyped_storage()
            self._arg_keys.setdefault(st._cdata, st.nbytes())

    def track_outputs(self, out) -> None:
        keys = {}
        for t in _tensors(out):
            st = t.untyped_storage()
            keys.setdefault(st._cdata, st.nbytes())
        self.output_bytes = sum(keys.values())

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self._live_bytes -= entry[0]
            del self._live[key]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._arg_keys:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self._live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self._live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _note_writes(self, func, args, kwargs) -> None:
        for i, a in enumerate(func._schema.arguments):
            info = a.alias_info
            if info is None or not info.is_write:
                continue
            val = (args[i] if i < len(args) else kwargs.get(a.name))
            for t in _tensors(val):
                key = _storage_key(t)
                if key in self._arg_keys:
                    self._aliased[key] = self._arg_keys[key]

    # ---------------------------------------------------------- counting
    def _add(self, flops: float, nbytes: float, trans: float = 0.0) -> None:
        self.flops += flops
        self.transcendentals += trans
        self.bytes += nbytes
        tag = region_of_stack()
        if tag is not None:
            cur = self.regions.setdefault(tag, [0.0, 0.0])
            cur[0] += flops
            cur[1] += nbytes

    def add_priced(self, name: str, route: Optional[str], nbytes: float,
                   operations: float) -> None:
        key = f"{name}/{route}" if route else name
        self.priced[key] = self.priced.get(key, 0) + 1
        self._add(float(operations), float(nbytes))

    def add_collective(self, family: str, out_bytes: float,
                       in_bytes: float) -> None:
        self.collectives[family] += out_bytes
        self._add(0.0, float(out_bytes + in_bytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self._note_writes(func, args, kwargs)
        for t in _tensors(out):
            self._track(t)
        if not self._suspended and not func.is_view:
            self._price(func, args, kwargs, out)
        return out

    def _price(self, func, args, kwargs, out) -> None:
        name = _op_name(func)
        if name in _FREE or name == "detach" or name == "alias":
            return
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        out_elems = sum(t.numel() for t in outs)
        if _is_inplace(func) and name in _SCATTER_INPLACE:
            idx = _SCATTER_INPLACE[name]
            upd = args[idx] if idx < len(args) else None
            if isinstance(upd, torch.Tensor):
                touched = _span_bytes(upd)
                n_upd = upd.numel()
            else:   # a scalar fill: the indices' (or mask's) elements
                index = args[1] if len(args) > 1 else None
                tensors = list(_tensors(index))
                n_upd = sum(t.numel() for t in tensors)
                touched = n_upd * args[0].element_size()
            index_bytes = sum(_span_bytes(t) for t in ins[1:]
                              if t is not upd and not t.is_floating_point())
            self._add(float(n_upd), 2.0 * touched + index_bytes)
            return
        if name in _GATHER:
            index_bytes = sum(_span_bytes(t) for t in ins[1:])
            self._add(0.0, 2.0 * sum(_span_bytes(t) for t in outs)
                      + index_bytes)
            return
        if name == "copy":
            # a source of one element (a scalar, broadcast) is a fill: on
            # the CPU the same assignment dispatches as ``fill_``
            src = sum(_span_bytes(t) for t in ins[1:]
                      if _span_bytes(t) > t.element_size())
            self._add(0.0, float(_span_bytes(ins[0]) + src))
            return
        if name in _WRITE_ONLY:
            self._add(0.0, float(sum(_span_bytes(t) for t in outs)))
            return
        nbytes = float(sum(_span_bytes(t) for t in ins)
                       + sum(_span_bytes(t) for t in outs))
        flops = trans = 0.0
        if name in _DOTS:
            flops = _dot_flops(name, args, outs)
        elif name in ("convolution", "_convolution",
                      "convolution_backward"):
            flops = _conv_flops(name, args, outs)
        elif name in _ELEMENTWISE_1FLOP:
            flops = float(out_elems)
        elif name in _TRANSCENDENTAL:
            flops = trans = float(out_elems)
        elif name in _COMPOSITE:
            f, tr = _COMPOSITE[name]
            flops, trans = f * float(out_elems), tr * float(out_elems)
        elif name in _REDUCE:
            flops = float(_numel(ins[0]) if ins else 0)
            if name == "mean":
                flops += out_elems
        self._add(flops, nbytes, trans)

    # ------------------------------------------------------------ result
    def result(self) -> Dict[str, Any]:
        coll = dict(self.collectives)
        coll["total"] = sum(self.collectives.values())
        return {
            "flops": self.flops,
            "transcendentals": self.transcendentals,
            "bytes": self.bytes,
            "collectives": coll,
            "regions": {t: {"flops": f, "bytes": b}
                        for t, (f, b) in self.regions.items()},
            "priced": dict(self.priced),
            "memory_analysis": {
                "argument_size_in_bytes": sum(self._arg_keys.values()),
                "output_size_in_bytes": self.output_bytes,
                "alias_size_in_bytes": sum(self._aliased.values()),
                "temp_size_in_bytes": self.peak_bytes,
            },
        }


def _dot_flops(name, args, outs) -> float:
    out = outs[0]
    if name in ("mm", "addmm", "_addmm_activation"):
        a = args[1] if name != "mm" else args[0]
        k = a.shape[-1]
        flops = 2.0 * out.numel() * k
        return flops + (out.numel() if name != "mm" else 0)
    if name in ("bmm", "baddbmm", "addbmm"):
        a = args[0] if name == "bmm" else args[1]
        flops = 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * (
            args[1] if name == "bmm" else args[2]).shape[-1]
        return flops + (out.numel() if name != "bmm" else 0)
    if name in ("mv", "addmv"):
        a = args[0] if name == "mv" else args[1]
        return 2.0 * a.numel() + (out.numel() if name == "addmv" else 0)
    if name == "dot":
        return 2.0 * args[0].numel()
    return 0.0


def _conv_flops(name, args, outs) -> float:
    """2·|out|·(C_in / groups)·|kernel| (the backward: the same for each
    gradient it returns)."""
    if name == "convolution_backward":
        grad_out, _, weight = args[0], args[1], args[2]
        per = 2.0 * grad_out.numel() * math.prod(weight.shape[1:])
        return per * sum(1 for t in outs if t is not None)
    weight = args[1]
    return 2.0 * outs[0].numel() * math.prod(weight.shape[1:])


def region_of_stack() -> Optional[str]:
    """The tag of the first :data:`REGION_TAGS` function (in the table's
    order) found on the Python stack, or None."""
    names = set()
    f = sys._getframe(2)
    while f is not None:
        names.add(f.f_code.co_name)
        f = f.f_back
    for fn, tag in REGION_TAGS.items():
        if fn in names:
            return tag
    return None


_ACTIVE: List[OpCounter] = []


def active() -> Optional[OpCounter]:
    """The innermost counter open on this process, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def counting() -> Iterator[OpCounter]:
    """Count the ops run inside the block with a new :class:`OpCounter`."""
    counter = OpCounter()
    _ACTIVE.append(counter)
    try:
        with counter:
            yield counter
    finally:
        _ACTIVE.pop()


_NOTHING = contextlib.nullcontext()


class _Suspended:
    """While open, the counter's ops are not counted (a priced call's or a
    collective's own ops)."""

    def __init__(self, counter: OpCounter):
        self.counter = counter

    def __enter__(self):
        self.counter._suspended += 1

    def __exit__(self, *exc):
        self.counter._suspended -= 1
        return False


def priced(name: str, price: Callable[[], Tuple[Optional[str], float,
                                               float]]):
    """A context for one call of the hand-written kernel ``name``:
    ``price()`` gives ``(route, bytes, operations)`` (the route None for a
    kernel with one design), added to the active counter, whose ops
    beneath are not counted while the block runs.  Without a counter it
    does nothing and ``price`` is not called (a wrapper's launch pays no
    pricing)."""
    counter = active()
    if counter is None:
        return _NOTHING
    route, nbytes, operations = price()
    counter.add_priced(name, route, nbytes, operations)
    return _Suspended(counter)


def collective(family: str, out_bytes: float, in_bytes: float = 0.0):
    """A context for one collective of ``family`` (one of
    :data:`COLLECTIVES`) whose output holds ``out_bytes``, tallied into
    the active counter; its ops beneath are not counted."""
    counter = active()
    if counter is None:
        return _NOTHING
    counter.add_collective(family, out_bytes, in_bytes)
    return _Suspended(counter)


def route_or_none(route: Callable, *args) -> Optional[str]:
    """``route(*args)``, or None where it refuses the case (a dtype or a
    head count the card takes on no route: its launch raises there, and
    the plain version on the CPU is priced without a route)."""
    try:
        return route(*args)
    except ValueError:
        return None


def dry(t: torch.Tensor) -> bool:
    """Is ``t`` a ``meta`` tensor inside an active counter: a dry run's
    call, which a kernel wrapper answers with :func:`meta_output`?  Outside
    a counter a meta tensor goes on to the CUDA launcher, which refuses
    it: the plain version never stands in for the kernel."""
    return t.device.type == "meta" and active() is not None


def meta_output(shape, dtype) -> torch.Tensor:
    """A kernel wrapper's output in a dry run: an empty ``meta`` tensor of
    the call's shape and dtype."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def counted_costs(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under a new counter and return its
    costs: ``flops``, ``bytes``, ``transcendentals``, ``collectives`` (by
    family, and ``total``), ``regions``, ``priced`` (kernel calls by
    ``"<kernel>/<route>"``), ``memory_analysis``
    (:meth:`OpCounter.result`), and ``count_s``, the seconds the run took.
    The output is dropped."""
    t0 = time.perf_counter()
    with counting() as counter:
        counter.track_args(*args, **kwargs)
        out = fn(*args, **kwargs)
        counter.track_outputs(out)
        del out
    res = counter.result()
    res["count_s"] = time.perf_counter() - t0
    return res
