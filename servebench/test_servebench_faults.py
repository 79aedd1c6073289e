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
