"""The one generator of every traffic mix (``traffic/<mix>.json``).

A mix is data: the loop kind, the length distributions, the sharing of
prompt prefixes, the warm-up and the profiled span (``README.md`` lists
the keys).  Sizes, their order and the arrival gaps come from one fixed
pool seed (``POOL_SEED``, not the run's), so every run seed sends the
same work: requests of the same lengths, in the same order, at the same
times.  The run seed draws the token ids (and the weights, elsewhere).

Loops:

- ``closed``: ``clients`` clients, each sending its next request when its
  last one completes.  Each client's first request is already running
  when the window opens (set-up prefills it): its output length is drawn
  from the residual of the length-biased output distribution, so lanes
  retire spread over the window and not in one wave.
- ``poisson`` / ``gamma``: requests due at ``rate`` a second, with gaps
  exponential or gamma-distributed at coefficient of variation ``cv``.

Prompt and output are clipped so that they fit ``max_len`` (prompt plus
output at most ``max_len - 2``, the engine's limit).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

LOOPS = ("closed", "poisson", "gamma")
POOL_SEED = 0


@dataclasses.dataclass
class Spec:
    """One request of the traffic: its prompt, how many tokens it asks
    for, the client (closed loop; -1 for set-up's requests) or the due
    offset in seconds from the window's start (open loop), and the shared
    context it starts with."""

    prompt: List[int]
    max_new: int
    client: int = 0
    due: float = 0.0
    context: Optional[int] = None
    first: bool = False


def draw_lengths(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths of ``spec``: ``{"dist": "lognormal", "median",
    "sigma", "min", "max"}``, ``{"dist": "uniform", "min", "max"}`` or
    ``{"dist": "fixed", "value"}``; whole numbers within the clip."""
    kind = spec["dist"]
    if kind == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if kind == "lognormal":
        x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    elif kind == "uniform":
        x = rng.uniform(spec["min"], spec["max"] + 1, n)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.floor(x), spec["min"], spec["max"]).astype(np.int64)


def residual_lengths(spec: Dict, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """``n`` residual lengths of ``spec``: a length drawn in proportion to
    its size (the request a lane is serving at a random moment), times a
    uniform share still to come; at least 1."""
    pool = draw_lengths(spec, max(4096, 64 * n), rng).astype(np.float64)
    biased = rng.choice(pool, size=n, p=pool / pool.sum())
    return np.maximum(1, np.ceil(biased * rng.uniform(0, 1, n))).astype(
        np.int64)


def gaps(loop: str, rate: float, cv: float, n: int,
         rng: np.random.Generator) -> np.ndarray:
    """``n`` arrival gaps in seconds at ``rate``: exponential (poisson) or
    gamma at coefficient of variation ``cv``."""
    if loop == "poisson":
        return rng.exponential(1.0 / rate, n)
    shape = 1.0 / (cv * cv)
    return rng.gamma(shape, 1.0 / (rate * shape), n)


def zipf_counts(n_items: int, exponent: float, total: int) -> np.ndarray:
    """How many of ``total`` requests go to each of ``n_items`` by
    Zipf(``exponent``) over popularity ranks, largest remainder first."""
    w = 1.0 / np.arange(1, n_items + 1) ** exponent
    share = w / w.sum() * total
    counts = np.floor(share).astype(np.int64)
    for i in np.argsort(-(share - counts))[:total - counts.sum()]:
        counts[i] += 1
    return counts


class Traffic:
    """The requests of one run of a mix: ``warm`` (set-up's requests that
    fill the prefix cache), and ``streams`` (closed loop: one list a
    client, its first request already running at the window's start) or
    ``arrivals`` (open loop: in due order)."""

    def __init__(self, mix: Dict, vocab: int, max_len: int, seed: int):
        self.loop = mix["loop"]
        if self.loop not in LOOPS:
            raise ValueError(f"loop must be one of {LOOPS}, got "
                             f"{self.loop!r}")
        self.max_len = max_len
        self.vocab = vocab
        pool = np.random.default_rng(POOL_SEED)
        run = np.random.default_rng(seed)
        n = mix["requests"]
        # closed loop: each client's first request comes on top of the n
        clients = mix["clients"] if self.loop == "closed" else 0
        total = n + clients
        prompts = draw_lengths(mix["prompt"], total, pool)
        outputs = draw_lengths(mix["output"], n, pool)
        if clients:
            outputs = np.concatenate(
                [outputs, residual_lengths(mix["output"], clients, pool)])
        sharing = mix.get("sharing")
        ctx_len, ctx_of = None, [None] * total
        if sharing:
            if sharing.get("fresh"):
                ctx_len = draw_lengths(sharing["length"], total, pool)
                ctx_of = list(range(total))
            else:
                k = sharing["contexts"]
                ctx_len = draw_lengths(sharing["length"], k, pool)
                counts = zipf_counts(k, sharing["zipf"], total)
                ctx_of = [int(c) for c in pool.permutation(
                    np.repeat(np.arange(k), counts))]
        # the order: regular requests among themselves, first ones among
        # themselves; a request keeps its context
        order = np.concatenate([pool.permutation(n),
                                n + pool.permutation(clients)])
        contexts = {}
        if ctx_len is not None:
            for c in sorted(set(ctx_of)):
                contexts[c] = run.integers(0, vocab, int(ctx_len[c])).tolist()
        self.contexts = contexts
        specs = []
        for j in range(total):
            i = int(order[j])
            ctx = ctx_of[i]
            head = contexts[ctx] if ctx is not None else []
            specs.append(self._spec(head, int(prompts[i]), int(outputs[i]),
                                    run, ctx))
        self.warm: List[Spec] = []
        if sharing and not sharing.get("fresh"):
            # no client's: finishing one sends nothing
            self.warm = [Spec(list(contexts[c]), 1, client=-1, context=c)
                         for c in sorted(contexts)]
        self.streams: List[List[Spec]] = []
        self.arrivals: List[Spec] = []
        if self.loop == "closed":
            regular, firsts = specs[:n], specs[n:]
            self.streams = [[firsts[c]] + regular[c::clients]
                            for c in range(clients)]
            for c, stream in enumerate(self.streams):
                for s in stream:
                    s.client = c
                stream[0].first = True
        else:
            due = np.cumsum(gaps(self.loop, mix["rate"], mix.get("cv", 1.0),
                                 n, pool))
            for s, t in zip(specs, due):
                s.due = float(t)
            self.arrivals = specs

    def _fit(self, prompt: int, output: int) -> int:
        return max(1, min(output, self.max_len - 2 - prompt))

    def _spec(self, head, prompt_len, out_len, run, ctx) -> Spec:
        cap = self.max_len - 3
        tail = run.integers(0, self.vocab, prompt_len).tolist()
        prompt = (head + tail)[:cap]
        return Spec(prompt, self._fit(len(prompt), out_len), context=ctx)
