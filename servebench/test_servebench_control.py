"""The control at a size a test run holds: the reference computed with
float8 inputs to every linear, put in the program's place, on three seeds
of each tiny model, must read above the tiny cells' limit of
``logit_rms_err`` where the program reads below every limit, and at least
three times the program.  (On the card, at the cells' own sizes, the
control reads three times the program's dozen seeds or more; PERF.md
gives both readings.)"""

import pytest

from servebench import testing


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testing.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["tiny-swiglu.mix", "tiny-gelu.shared"])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 987654321012])
def test_control_fails_where_the_program_passes(root, seed, cell):
    out = testing.run_tiny(root, cell, seed=seed, control=True)
    check = out["result"]["check"]
    program = check["logit_rms_err"]["value"]
    control = check["control_logit_rms_err"]["value"]
    limit = check["logit_rms_err"]["limit"]
    assert out["result"]["correct"]
    assert check["max_gap"]["value"] <= check["max_gap"]["limit"]
    assert program <= limit < control
    assert control >= 3 * program
