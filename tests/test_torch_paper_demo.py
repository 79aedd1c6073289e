"""PyTorch port vs JAX: the paper's demo, end to end, on the CPU.

``repro_torch.paper_demo.run(dim, device="cpu")`` against what
``examples/gemv_paper_demo.py`` computes with the JAX package on the same
seeded integers: the ISA program's words, the tile model's exact result,
cycles and instruction count (equal), the Fig. 6 table (equal), and the
engine's relative error on the 8-bit quantized weights, within 1e-6 of what
JAX's bit-plane kernel (interpret mode) gives.  The error itself is the
quantization's (a few 1e-3); 1e-6 allows the two packages' float32 sums
to differ in their last bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.controller import run_gemv as jax_run_gemv
from repro.core.isa import assemble_gemv as jax_assemble
from repro.core.isa import roundtrip as jax_roundtrip
from repro.core.latency_model import FIG6_DESIGNS as JAX_FIG6
from repro.engine import EnginePlan as JaxEnginePlan
from repro.engine import pack_linear as jax_pack_linear

from repro_torch import paper_demo


def _jax_demo(dim, cols):
    rng = np.random.default_rng(0)
    w = rng.integers(-127, 128, size=(dim, dim))
    x = rng.integers(-127, 128, size=(dim,))
    res = jax_run_gemv(w, x, rows=16, cols=cols)
    ql = jax_pack_linear(jnp.asarray(w.T, jnp.float32), bits=8)
    y = JaxEnginePlan(backend="pallas_interpret", bits=8, radix=1).apply(
        ql, jnp.asarray(x, jnp.float32), out_dtype=jnp.float32)
    err = float(np.max(np.abs(np.asarray(y) - (w @ x))))
    rel = err / max(1.0, float(np.max(np.abs(w @ x))))
    return res, rel, w @ x


@pytest.mark.parametrize("dim,cols", [(96, 8), (64, 8), (300, 10)])
def test_demo_matches_jax(dim, cols):
    r = paper_demo.run(dim, device="cpu")
    jres, jrel, want = _jax_demo(dim, cols)
    words = jax_roundtrip(jax_assemble(n_elems=12, n_folds=1,
                                       out_rows=16))[0]
    assert r["words"] == words and r["instructions"] == len(words)
    assert r["exact"] is True
    np.testing.assert_array_equal(r["y"], want)
    assert (r["cycles"], r["instrs"]) == (jres.cycles, jres.instrs)
    assert r["exec_us"] == jres.cycles / 737.0
    assert r["backend"] == "reference" and r["device"] == "cpu"
    assert 1e-4 < r["rel_err_bitplane"] < 1e-2
    assert abs(r["rel_err_bitplane"] - jrel) <= 1e-6
    assert abs(r["rel_err_int8"] - jrel) <= 1e-6
    assert r["fig6"] == [
        dict(design=name, cycles=fn(dim, 8),
             exec_us=fn(dim, 8) / f if f else None)
        for name, (fn, f) in JAX_FIG6.items()]


def test_demo_main_prints_the_four_steps(capsys):
    assert paper_demo.main(["--dim", "64", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for step in ("== 1.", "== 2.", "== 3.", "== 4."):
        assert step in out
    assert "exact=True" in out and "BRAMAC" in out


def test_demo_refuses_a_dim_whose_sums_are_not_exact():
    with pytest.raises(ValueError, match="dim"):
        paper_demo.run(paper_demo.MAX_DIM + 1, device="cpu")
