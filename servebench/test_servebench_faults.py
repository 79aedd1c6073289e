"""A whole run with the timed path broken underneath must come out not
correct: the harness's look for a card is skipped and the engine of a tiny
cell is broken, once for each fault a served cell can have.  (The cells
run on one card: there is no exchange between cards to leave out.)"""

import pytest
import torch

from servebench import testing

CELL = "tiny-swiglu.mix"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testing.make_root(tmp_path_factory.mktemp("tiny"))


def state_unchanged(eng):
    """The decode step returns its logits but leaves the pool as it found
    it: the step's K/V never land."""
    step = eng._decode_paged
    pools = [eng.pages.k, eng.pages.v, eng.pages.k_scale, eng.pages.v_scale]

    def frozen():
        saved = [p.clone() for p in pools]
        out = step()
        for p, s in zip(pools, saved):
            p.copy_(s)
        return out
    eng._decode_paged = frozen


def half_the_batch(eng):
    """The decode step computes half of its lanes; the other half take the
    first half's results."""
    step = eng._decode_paged

    def half():
        out = step().clone()
        n = out.shape[0] // 2
        out[n:2 * n] = out[:n]
        return out
    eng._decode_paged = half


def altered_token(eng):
    """Every fifth token is changed where it is sampled."""
    sample, calls = eng._sample_next, [0]

    def altered(req):
        tok = sample(req)
        calls[0] += 1
        return (tok + 1) % eng.cfg.vocab_size if calls[0] % 5 == 0 else tok
    eng._sample_next = altered


def test_sound_run_is_correct(root):
    out = testing.run_tiny(root, CELL)
    assert out["result"]["correct"]


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   altered_token], ids=lambda f: f.__name__)
def test_fault_is_caught(root, fault):
    out = testing.run_tiny(root, CELL, hooks=fault)
    check = out["result"]["check"]
    assert not out["result"]["correct"]
    assert check["max_gap"]["value"] > check["max_gap"]["limit"]


def test_no_finished_request_is_not_correct(root):
    def stall(eng):
        eng.scfg = eng.scfg.__class__(**{**eng.scfg.__dict__})
        step = eng._decode_paged
        eng._decode_paged = lambda: torch.full_like(step(), float("nan"))
    out = testing.run_tiny(root, CELL, hooks=stall)
    assert not out["result"]["correct"]


def test_float8_linear_inputs_are_caught(root, monkeypatch):
    """Every linear of the timed path fed its input through float8 e4m3,
    as a faster GEMV might take it: the served tokens stay near the
    reference's best, the logits do not."""
    from repro_torch.models import layers, transformer

    from servebench.reference.model import fp8_rows

    dense = layers.dense

    def fp8_dense(p, x, plan=None):
        return dense(p, fp8_rows(x.float()).to(x.dtype), plan)
    monkeypatch.setattr(layers, "dense", fp8_dense)
    monkeypatch.setattr(transformer, "dense", fp8_dense)
    out = testing.run_tiny(root, CELL)
    check = out["result"]["check"]
    assert not out["result"]["correct"]
    assert check["logit_rms_err"]["value"] > check["logit_rms_err"]["limit"]


def test_kept_logits_are_the_served_tokens(root):
    """Each row of logits the client keeps sits at the position whose next
    token the program served from it (greedy: its best), and each
    finished request keeps its last prompt position."""
    import numpy as np

    from servebench import harness
    from servebench.client import Client

    seen = {}
    real = Client.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        seen["client"] = self
    Client.__init__ = init
    try:
        testing.run_tiny(root, CELL)
    finally:
        Client.__init__ = real
    cli = seen["client"]
    done = [r for r in cli.records if r.finished is not None and r.req.output]
    assert done and cli.n_logits > len(done)
    for r in done:
        seq = list(r.req.prompt) + list(r.req.output)
        assert r.logit_rows[0][0] == len(r.req.prompt) - 1
        for pos, row in r.logit_rows:
            if pos < len(seq) - 1:
                assert int(np.argmax(cli.logits[row])) == seq[pos + 1]
    assert harness.COMPARED == ("max_gap", "logit_rms_err")


def _client_of_run(root, **kw):
    """Run the tiny cell; return its result and the client it drove."""
    from servebench.client import Client

    seen = {}
    real = Client.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        seen["client"] = self
    Client.__init__ = init
    try:
        out = testing.run_tiny(root, CELL, **kw)
    finally:
        Client.__init__ = real
    return out, seen["client"]


def test_a_request_running_at_close_is_compared(root):
    """One request that the window admitted and that still runs at its
    close is scored, its tokens served by the close; a token altered in
    those requests alone, none of which finishes in the window, reads not
    correct."""
    from servebench import check

    out, cli = _client_of_run(root)
    info = out["info"]
    assert out["result"]["correct"]
    assert info["running_at_close"] >= 1 and info["compared_running"] == 1
    t0, t1 = cli.t_open, max(s.t1 for s in cli.steps)
    late = check.running_at_close(cli.records, t0, t1)
    assert late and all(r.finished is None or r.finished > t1 for r in late)
    targets = {tuple(r.req.prompt) for r in late}

    def altered_late(eng):
        sample = eng._sample_next

        def altered(req):
            tok = sample(req)
            if tuple(req.prompt) in targets:
                return (tok + 1) % eng.cfg.vocab_size
            return tok
        eng._sample_next = altered

    faulty = testing.run_tiny(root, CELL, hooks=altered_late)
    assert faulty["info"]["compared_running"] == 1
    assert not faulty["result"]["correct"]
    mg = faulty["result"]["check"]["max_gap"]
    assert mg["value"] > mg["limit"]


def test_sample_takes_the_longest_and_one_running_at_close():
    """``check.sample`` on made-up records: the longest finished request,
    one request sent in the window and running at its close (cut to the
    tokens served by then; not one sent before the window, nor one with
    no token yet), then others within the budget."""
    from types import SimpleNamespace

    import numpy as np

    from servebench import check

    def rec(prompt, out, sent, stamps, finished=None):
        req = SimpleNamespace(prompt=[1] * prompt, output=[2] * out,
                              finish_reason="length" if finished else None)
        return SimpleNamespace(req=req, sent=sent, stamps=stamps,
                               finished=finished)

    t0, t1 = 10.0, 20.0
    longest = rec(5, 6, 1.0, [9.0 + i for i in range(6)], finished=15.0)
    short = rec(5, 2, 11.0, [12.0, 13.0], finished=13.0)
    running = rec(7, 5, 12.0, [18.0, 19.0, 21.0, 22.0, 23.0])
    from_setup = rec(3, 4, 1.0, [9.0, 11.0, 12.0, 13.0])     # sent before
    prefilling = rec(30, 0, 19.0, [])                        # no token yet
    records = [longest, short, running, from_setup, prefilling]
    assert check.running_at_close(records, t0, t1) == [running]
    for seed in (1, 2 ** 31 + 9):
        got = check.sample(records, t0, t1, seed, budget=11 + 9)
        assert got[:2] == [(longest, 6), (running, 2)]
        assert got == [(longest, 6), (running, 2)]      # short: over budget
        got = check.sample(records, t0, t1, seed, budget=11 + 9 + 7)
        assert got == [(longest, 6), (running, 2), (short, 2)]
    assert check.sample([running, from_setup], t0, t1, 1, 100) == []
    rows = SimpleNamespace(req=running.req,
                           logit_rows=[(6, 0), (7, 1), (8, 2), (9, 3)])
    logits = np.arange(8, dtype=np.float32).reshape(4, 2)
    assert [p for p, _ in check.kept_rows(rows, logits, 2)] == [6, 7]
