"""PyTorch port vs JAX: the FPGA executable model of the paper.

``repro_torch.core.{isa, controller, latency_model, tile_array}`` are the
port's own copies of the JAX package's numpy modules.  Each function is
held **equal** to JAX's on the same inputs (no tolerance: integers, and
floats computed by the same expressions): ISA words and decoded fields,
``assemble_gemv`` programs, ``run_gemv`` results, cycles, instruction
counts and instructions, ``CycleModel`` costs, every ``FIG6_DESIGNS``
model at the Fig. 6 dimensions and p in {4, 8, 16}, ``execution_time_us``,
``peak_tops``, ``clock_speedup_range``, the paper's tables and the tile
geometries.  Then the checks of ``tests/test_isa.py`` and
``tests/test_paper_claims.py`` run against the port's modules.
"""

import numpy as np
import pytest

from repro.core import controller as jctl
from repro.core import isa as jisa
from repro.core import latency_model as jlm
from repro.core import tile_array as jta

from repro_torch.core import controller as ctl
from repro_torch.core import isa
from repro_torch.core import latency_model as lm
from repro_torch.core import tile_array as ta

FIELDS = [(0, 0, 0, 0), (1, 2, 3, 4), (63, 63, 63, 127), (34, 2, 35, 0),
          (5, 60, 1, 99)]
DIMS = [64, 128, 256, 512, 1024, 2048]
PRECISIONS = [4, 8, 16]


def _fields(i):
    return int(i.op), i.rd, i.rs1, i.rs2, i.imm


# ------------------------------------------------------------------- ISA
@pytest.mark.parametrize("fields", FIELDS, ids=str)
@pytest.mark.parametrize("op", [int(o) for o in jisa.Op])
def test_isa_words_equal_jax(op, fields):
    word = isa.Instr(isa.Op(op), *fields).encode()
    assert word == jisa.Instr(jisa.Op(op), *fields).encode()
    assert 0 <= word < 1 << isa.INSTR_BITS
    assert _fields(isa.decode(word)) == _fields(jisa.decode(word))
    assert isa.decode(word) == isa.Instr(isa.Op(op), *fields)


def test_isa_random_words_equal_jax():
    """200 seeded instructions (``test_encode_decode_roundtrip``'s range)."""
    rng = np.random.default_rng(0)
    ops = list(isa.Op)
    for _ in range(200):
        op = ops[int(rng.integers(len(ops)))]
        f = (int(rng.integers(64)), int(rng.integers(64)),
             int(rng.integers(64)), int(rng.integers(128)))
        word = isa.Instr(op, *f).encode()
        assert word == jisa.Instr(jisa.Op(int(op)), *f).encode()
        assert isa.decode(word) == isa.Instr(op, *f)


@pytest.mark.parametrize("case", ["rd=64", "imm=128", "rs1=-1", "word"])
def test_isa_rejects_out_of_range_as_jax(case):
    for mod in (isa, jisa):
        with pytest.raises(ValueError):
            if case == "word":
                mod.decode(1 << 30)
            else:
                name, val = case.split("=")
                mod.Instr(mod.Op.ADD, **{name: int(val)}).encode()


@pytest.mark.parametrize("n_elems,n_folds,out_rows",
                         [(5, 2, 4), (12, 1, 16), (30, 3, 8), (1, 1, 1),
                          (0, 2, 0)])
def test_assemble_gemv_equals_jax(n_elems, n_folds, out_rows):
    prog = isa.assemble_gemv(n_elems, n_folds, out_rows)
    jprog = jisa.assemble_gemv(n_elems, n_folds, out_rows)
    assert [_fields(i) for i in prog] == [_fields(i) for i in jprog]
    words, decoded = isa.roundtrip(prog)
    assert words == jisa.roundtrip(jprog)[0]
    assert decoded == prog


def test_assemble_gemv_refuses_what_jax_refuses():
    for mod in (isa, jisa):
        with pytest.raises(ValueError):
            mod.assemble_gemv(mod.MAX_ELEMS + 1, 1, 1)


def test_register_map_equals_jax():
    names = ("INSTR_BITS", "REG_ACC", "REG_TMP", "REG_W_BASE", "REG_X_BASE",
             "MAX_ELEMS")
    assert {n: getattr(isa, n) for n in names} == {
        n: getattr(jisa, n) for n in names}
    assert {int(o) for o in isa.SINGLE_CYCLE} == {
        int(o) for o in jisa.SINGLE_CYCLE}
    assert {o.name: int(o) for o in isa.Op} == {
        o.name: int(o) for o in jisa.Op}


# ------------------------------------------------------------ controller
RUNS = [(8, 16, 8, 4), (40, 64, 16, 8), (96, 96, 16, 8), (33, 200, 16, 7),
        (1, 1, 16, 8), (240, 240, 16, 8), (300, 300, 32, 12)]


@pytest.mark.parametrize("m,k,rows,cols", RUNS, ids=str)
def test_run_gemv_equals_jax(m, k, rows, cols):
    rng = np.random.default_rng(m * 1000 + k)
    w = rng.integers(-127, 128, size=(m, k))
    x = rng.integers(-127, 128, size=(k,))
    res = ctl.run_gemv(w, x, rows=rows, cols=cols)
    jres = jctl.run_gemv(w, x, rows=rows, cols=cols)
    np.testing.assert_array_equal(res.y, w @ x)
    np.testing.assert_array_equal(res.y, jres.y)
    assert res.y.dtype == jres.y.dtype
    assert (res.cycles, res.instrs) == (jres.cycles, jres.instrs)
    assert {int(o): n for o, n in res.ctrl.instr_count.items()} == {
        int(o): n for o, n in jres.ctrl.instr_count.items()}
    assert res.ctrl.halted and jres.ctrl.halted


@pytest.mark.parametrize("radix_bits", [1, 2])
@pytest.mark.parametrize("p", PRECISIONS)
def test_cycle_model_equals_jax(p, radix_bits):
    cm = ctl.CycleModel(precision=p, acc_width=2 * p + 8,
                        radix_bits=radix_bits)
    jcm = jctl.CycleModel(precision=p, acc_width=2 * p + 8,
                          radix_bits=radix_bits)
    assert (cm.mult(), cm.add(), cm.add(9), cm.mac(), cm.mov(),
            cm.accum(7), cm.single()) == (
        jcm.mult(), jcm.add(), jcm.add(9), jcm.mac(), jcm.mov(),
        jcm.accum(7), jcm.single())
    for op in isa.Op:
        assert cm.for_instr(isa.Instr(op), 5) == jcm.for_instr(
            jisa.Instr(jisa.Op(int(op))), 5)


def test_run_gemv_refuses_what_jax_refuses():
    w = np.ones((4, 64), dtype=np.int64)
    x = np.ones(64, dtype=np.int64)
    for mod in (ctl, jctl):
        with pytest.raises(ValueError):
            mod.run_gemv(w, x, rows=4, cols=2)   # 32 elements per PE


# --------------------------------------------------------- latency model
@pytest.mark.parametrize("p", PRECISIONS)
@pytest.mark.parametrize("design", list(jlm.FIG6_DESIGNS))
def test_fig6_models_equal_jax(design, p):
    fn, f_mhz = lm.FIG6_DESIGNS[design]
    jfn, jf_mhz = jlm.FIG6_DESIGNS[design]
    assert f_mhz == jf_mhz
    assert [fn(d, p) for d in DIMS] == [jfn(d, p) for d in DIMS]
    if f_mhz is None:
        for mod in (lm, jlm):
            with pytest.raises(ValueError):
                mod.execution_time_us(design, 256, p)
    else:
        assert [lm.execution_time_us(design, d, p) for d in DIMS] == [
            jlm.execution_time_us(design, d, p) for d in DIMS]


@pytest.mark.parametrize("p", PRECISIONS)
def test_cycle_functions_equal_jax(p):
    for d in DIMS + [96, 1983]:
        assert lm.imagine_cycles(d, p) == jlm.imagine_cycles(d, p)
        assert lm.imagine_cycles(d, p, radix_bits=2) == jlm.imagine_cycles(
            d, p, radix_bits=2)
        assert lm.ccb_cycles(d, p) == jlm.ccb_cycles(d, p)
        assert lm.comefa_cycles(d, p) == jlm.comefa_cycles(d, p)
        assert lm.spar2_cycles(d, p) == jlm.spar2_cycles(d, p)
        assert lm.bramac_cycles(d, p) == jlm.bramac_cycles(d, p)


@pytest.mark.parametrize("radix_bits", [1, 2])
@pytest.mark.parametrize("p", PRECISIONS)
def test_peak_tops_equals_jax(p, radix_bits):
    assert lm.peak_tops(p, radix_bits=radix_bits) == jlm.peak_tops(
        p, radix_bits=radix_bits)


def test_tables_and_constants_equal_jax():
    assert lm.clock_speedup_range() == jlm.clock_speedup_range()
    assert lm.TABLE_I == jlm.TABLE_I
    assert lm.TABLE_III == jlm.TABLE_III
    assert lm.TABLE_V == jlm.TABLE_V
    assert [(d.part, d.tech, d.brams, d.lut_bram_ratio, d.short_id,
             d.max_pes) for d in lm.TABLE_IV] == [
        (d.part, d.tech, d.brams, d.lut_bram_ratio, d.short_id, d.max_pes)
        for d in jlm.TABLE_IV]
    names = ("PE_PER_BRAM", "IMAGINE_FSYS_MHZ", "TPU_V1_MHZ", "TPU_V1_PES",
             "TPU_V2_PES", "HANGUANG800_MHZ", "MAX_ELEMS_FIG6",
             "CCB_GEMV_PES")
    assert {n: getattr(lm, n) for n in names} == {
        n: getattr(jlm, n) for n in names}


# ------------------------------------------------------------ tile array
@pytest.mark.parametrize("short_id", [d.short_id for d in jlm.TABLE_IV])
def test_geometries_equal_jax(short_id):
    g, jg = ta.all_geometries()[short_id], jta.all_geometries()[short_id]
    assert (g.n_tiles, g.n_pes, g.pe_rows, g.pe_cols) == (
        jg.n_tiles, jg.n_pes, jg.pe_rows, jg.pe_cols)
    for bits in (2, 4, 8):
        d = g.max_square_gemv(bits)
        assert d == jg.max_square_gemv(bits)
        for m, k in ((d, d), (64, 64), (4 * d, d)):
            assert g.occupancy(m, k, bits) == jg.occupancy(m, k, bits)


def test_u55_geometry_equals_jax():
    g, jg = ta.u55_geometry(), jta.u55_geometry()
    assert g.device.short_id == jg.device.short_id == "U55"
    assert g.max_square_gemv(8) == jg.max_square_gemv(8) == 1983
    names = ("BRAMS_PER_TILE", "BLOCK_GRID", "PES_PER_BLOCK", "PES_PER_TILE",
             "PE_REGFILE_BITS")
    assert {n: getattr(ta, n) for n in names} == {
        n: getattr(jta, n) for n in names}


# ---------------------- tests/test_isa.py and test_paper_claims.py, ported
def _cycle_accounting():
    rng = np.random.default_rng(0)
    w = rng.integers(-8, 8, size=(8, 16))
    x = rng.integers(-8, 8, size=(16,))
    res = ctl.run_gemv(w, x, rows=8, cols=4)
    cm = ctl.CycleModel()
    expect = sum(cm.for_instr(isa.Instr(op), n_cols=4) * n
                 for op, n in res.ctrl.instr_count.items())
    assert res.cycles == expect + 4 + 4  # activation + weight loads


def _drivers():
    cm = ctl.CycleModel(precision=8)
    for op in isa.SINGLE_CYCLE:
        assert cm.for_instr(isa.Instr(op), 4) == 1
    assert cm.for_instr(isa.Instr(isa.Op.MULT), 4) > 8
    assert cm.for_instr(isa.Instr(isa.Op.MAC), 4) > cm.for_instr(
        isa.Instr(isa.Op.MULT), 4)


def _radix4_halves_mult():
    r2 = ctl.CycleModel(precision=8, radix_bits=1)
    r4 = ctl.CycleModel(precision=8, radix_bits=2)
    assert r4.mult() - r4.issue == (r2.mult() - r2.issue) // 2


def _halt_stops():
    c = ctl.GemvTileController(2, 2)
    c.execute([isa.Instr(isa.Op.HALT)])
    with pytest.raises(RuntimeError):
        c.execute([isa.Instr(isa.Op.NOP)])


def _controller_exact():
    rng = np.random.default_rng(1)
    for _ in range(25):
        m, k = int(rng.integers(1, 41)), int(rng.integers(1, 65))
        w = rng.integers(-127, 128, size=(m, k))
        x = rng.integers(-127, 128, size=(k,))
        res = ctl.run_gemv(w, x, rows=16, cols=8)
        np.testing.assert_array_equal(res.y, w @ x)
        assert res.cycles > 0


def _clock_737():
    assert lm.IMAGINE_FSYS_MHZ == 737.0
    assert lm.TABLE_V["IMAGine"][4] == 737
    assert lm.TABLE_V["IMAGine"][3] == 100.0
    assert lm.IMAGINE_FSYS_MHZ > lm.TPU_V1_MHZ


def _speedup_range():
    lo, hi = lm.clock_speedup_range()
    assert abs(lo - 2.65) < 0.02 and 3.15 < hi < 3.20


def _table1():
    for name, (_, _, f_bram, f_pim, _) in lm.TABLE_I.items():
        assert (f_pim == f_bram) if name == "PiCaSO" else (f_pim < f_bram)


def _pe_counts():
    assert lm.U55.brams == 2016 and lm.U55.max_pes == 64512
    assert abs(lm.U55.max_pes - lm.TPU_V1_PES) / lm.TPU_V1_PES < 0.02
    assert lm.U55.max_pes > 3.9 * lm.TPU_V2_PES
    expect = {"U55": 64512, "V7-a": 24000, "US-a": 23040, "US-d": 86016}
    for dev in lm.TABLE_IV:
        assert dev.max_pes == dev.brams * 32
        assert dev.max_pes == expect.get(dev.short_id, dev.max_pes)


def _bram_scaling():
    for dev in lm.TABLE_IV:
        g = ta.TileArrayGeometry(dev)
        assert g.n_tiles * ta.BRAMS_PER_TILE <= dev.brams
        assert g.n_pes == g.n_tiles * ta.PES_PER_TILE
        assert g.n_tiles * ta.BRAMS_PER_TILE / dev.brams > 0.94


def _throughput():
    assert abs(lm.peak_tops(p=8) - 0.33) / 0.33 < 0.05
    r2 = ctl.CycleModel(precision=8, radix_bits=1).mac()
    r4 = ctl.CycleModel(precision=8, radix_bits=2).mac()
    assert 0.45 < r4 / r2 < 0.62


def _fig6_order():
    f = {k: v[0] for k, v in lm.FIG6_DESIGNS.items()}
    for d in DIMS:
        for name in ("IMAGine", "CCB", "SPAR-2"):
            assert f["BRAMAC"](d, 8) < f[name](d, 8)
        im, spar2 = f["IMAGine"](d, 8), f["SPAR-2"](d, 8)
        assert f["CCB"](d, 8) < im
        assert im < (0.5 if d >= 1024 else 1.05) * spar2
        assert f["IMAGine-slice4"](d, 8) < 1.9 * f["CCB"](d, 8)
        for name in ("CCB", "CoMeFa", "SPAR-2"):
            assert lm.execution_time_us("IMAGine", d, 8) < \
                lm.execution_time_us(name, d, 8)
    ratio = f["SPAR-2"](2048, 8) / f["SPAR-2"](1024, 8)
    assert 2.5 < ratio < 6.0


def _geometry():
    assert ta.BRAMS_PER_TILE == 12 and ta.PES_PER_TILE == 384
    g = ta.u55_geometry()
    assert g.n_tiles == 168
    d = g.max_square_gemv(bits=8)
    assert 1000 < d < 4096 and g.occupancy(d, d) <= 1.0


CLAIMS = {
    "cycle_accounting": _cycle_accounting, "drivers": _drivers,
    "radix4_halves_mult": _radix4_halves_mult, "halt_stops": _halt_stops,
    "controller_exact": _controller_exact, "clock_737": _clock_737,
    "speedup_2.65_3.2": _speedup_range, "table1": _table1,
    "pe_counts": _pe_counts, "bram_scaling": _bram_scaling,
    "throughput": _throughput, "fig6_order": _fig6_order,
    "geometry": _geometry,
}


@pytest.mark.parametrize("claim", list(CLAIMS))
def test_paper_claims_hold_for_the_port(claim):
    CLAIMS[claim]()
