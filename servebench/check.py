"""Whether what the timed path served is correct.

Once the window has closed and the engine is freed, a sample of the
window's requests, drawn from the seed (:func:`sample`: the longest that
finished in it, and one that the window admitted and that was still
running at its close, so that a prompt prefilled by the window's chunk
steps on a recycled lane is always scored), is scored by the plain
reference of the configuration's family
(the family module's ``score``: ``reference/model.py`` for the dense
family), which runs each prompt with its served tokens in the
configuration's precision.  Two numbers are compared, each held to the cell's limit
(``cells/<workload>.json``):

- ``max_gap``: at every served position, the gap by which the served
  token's logit lies below the reference's best; the widest.  Decoding
  is greedy, so a served token that is not the reference's best can only
  be a near tie.  An altered token, or a lane served another lane's
  logits, reads far over it.
- ``logit_rms_err``: at the positions whose logits the client kept
  (``client.py``: each request's last prompt position and a decode
  position a step in turn), the root mean square, over those positions
  and the vocabulary, of the program's logits less the reference's.  It
  reads the precision of the whole step: a linear fed float8 reads
  several times over it where ``max_gap`` moves less.

``control=True`` also reads the control: the reference with float8
inputs to every packed linear, whose top token at each position is scored in
the reference's logits (``control_max_gap``) and whose logits at the kept
positions are held against the reference's (``control_logit_rms_err``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def finished_in_window(records, t0: float, t1: float) -> List:
    return [r for r in records
            if r.finished is not None and t0 < r.finished <= t1
            and r.req.finish_reason == "length" and r.req.output]


def served_by(rec, t1: float) -> int:
    """How many of ``rec``'s output tokens were served by ``t1``."""
    return sum(stamp <= t1 for stamp in rec.stamps)


def running_at_close(records, t0: float, t1: float) -> List:
    """The requests sent in the window and still running at its close
    that had a token served by then: the window prefilled their
    prompts."""
    return [r for r in records
            if r.sent > t0 and (r.finished is None or r.finished > t1)
            and served_by(r, t1) > 0]


def sample(records, t0: float, t1: float, seed: int,
           budget: int) -> List[Tuple[object, int]]:
    """``(record, output tokens compared)`` of: the longest request
    finished in the window (most served tokens); one request of
    :func:`running_at_close`, drawn from ``seed``, with the tokens served
    by the close; then the others of both kinds in an order drawn from
    ``seed`` while their prompts and served tokens stay within ``budget``
    tokens.  Nothing where no request finished in the window."""
    done = finished_in_window(records, t0, t1)
    if not done:
        return []
    running = running_at_close(records, t0, t1)
    served = {id(r): len(r.req.output) for r in done}
    served.update((id(r), served_by(r, t1)) for r in running)

    def size(r):
        return len(r.req.prompt) + served[id(r)]

    rng = np.random.default_rng([int(seed), 17])
    longest = max(done, key=lambda r: (len(r.req.output), size(r)))
    chosen = [longest]
    if running:
        chosen.append(running[int(rng.integers(len(running)))])
    total = sum(size(r) for r in chosen)
    rest = [r for r in done + running if all(r is not c for c in chosen)]
    for i in rng.permutation(len(rest)):
        if total + size(rest[i]) <= budget:
            chosen.append(rest[i])
            total += size(rest[i])
    return [(r, served[id(r)]) for r in chosen]


def kept_rows(rec, logits: np.ndarray, served: int):
    """The rows of the program's logits that the client kept at the
    positions of ``rec`` that predict its first ``served`` output tokens,
    in position order, copied out of the client's table:
    ``[(position, row)]``."""
    lo = len(rec.req.prompt) - 1
    hi = len(rec.req.prompt) + served - 1
    return [(pos, torch.from_numpy(np.array(logits[row])))
            for pos, row in sorted(rec.logit_rows) if lo <= pos < hi]


def _rms_err(program: torch.Tensor, ref: torch.Tensor) -> float:
    """The root mean square of ``program - ref`` over every row and
    column."""
    d = program.to(torch.float32) - ref.to(torch.float32)
    return float(torch.sqrt(torch.mean(d * d)))


def compare(family, model: Dict, engine: Dict, seed: int, chosen, device,
            control: bool = False) -> Dict[str, float]:
    """The numbers over ``chosen`` (each with ``req.prompt``,
    ``req.output`` and ``rows``, from :func:`kept_rows`), scored by
    ``family.score`` (the configuration's family module), with how many
    tokens and kept rows were compared; with ``control`` the control's
    too."""
    seqs = [list(r.req.prompt) + list(r.req.output) for r in chosen]
    positions = [range(len(r.req.prompt) - 1, len(s) - 1)
                 for r, s in zip(chosen, seqs)]
    keep = [[pos for pos, _ in r.rows] for r in chosen]
    rows = [r.rows for r in chosen if r.rows]
    low = None
    if control:
        low = family.score(model, engine, seed, seqs, positions, device,
                           act_format="fp8", keep=keep)
    ref = family.score(model, engine, seed, seqs, positions, device,
                       keep=keep,
                       extra=None if low is None
                       else [rec["top"].tolist() for rec in low])
    program = torch.cat([torch.stack([row for _, row in r]) for r in rows]
                        ) if rows else None
    ref_rows = torch.cat([rec["logits"] for rec, k in zip(ref, keep) if k]
                         ) if rows else None
    out = {"max_gap": max(float((r["best"] - r["next_logit"]).max())
                          for r in ref),
           "logit_rms_err": (None if program is None
                             else _rms_err(program, ref_rows)),
           "logit_rows": 0 if program is None else len(program),
           "compared_tokens": sum(len(p) for p in positions),
           "compared_requests": len(chosen)}
    if control:
        out["control_max_gap"] = max(
            float((r["best"] - r["extra_logit"]).max()) for r in ref)
        if rows:
            low_rows = torch.cat([rec["logits"]
                                  for rec, k in zip(low, keep) if k])
            out["control_logit_rms_err"] = _rms_err(low_rows, ref_rows)
    return out
