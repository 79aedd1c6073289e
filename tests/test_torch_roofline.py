"""PyTorch port vs JAX: the roofline of a cell.

The port counts an eager program under ``roofline.op_cost.OpCounter`` where
JAX walks the compiled HLO (``repro/roofline/hlo_cost.py``); these cases
mirror ``tests/test_roofline.py`` and hold the two against each other:

* **Counting**: one product counts 2·M·K·N exactly; a Python loop of L
  products counts L of them, equal (within 1%, as JAX's own test) to JAX's
  ``analyze_hlo_text`` of the ``lax.scan`` version; nested loops (3 x 5)
  exactly; bytes scale with the trips exactly.
* **Regions**: ``attend_flash``'s FLOPs land in region ``attention``, more
  than half of the program's.
* **Collectives**: a dry ``(4, 2)`` mesh tallies each family's bytes
  exactly.
* **Report arithmetic**: ``roofline_report`` equals JAX's on the same
  inputs (a stub compiled artifact for JAX, the same numbers for the port,
  both on JAX's ``HW_V5E``); ``model_flops_for_cell`` /
  ``model_bytes_for_cell`` and ``param_count`` / ``active_param_count``
  equal JAX's for all 10 configs, exactly.
* **Kernel bounds**: ``roofline.kernel_costs`` gives every bound of
  ``PERF.md``'s kernel table to its printed digits.
* **cpu = meta**: a paged decode step and a chunk of reduced qwen2.5-3b
  through the ``cuda`` attention backend count the same on ``cpu`` and on
  ``meta``, to the unit.
* **Against JAX's compiled program** (``tests/test_costs.py``'s two shapes,
  kv 0 and 8, engine off, ``gather`` on both sides): the decode and chunk
  steps' counted FLOPs within 5% of ``compiled_costs``, the train cell's
  at shape ``a`` within 10%.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SHAPES as J_SHAPES
from repro.config import get_arch as j_get_arch
from repro.config.base import ModelConfig as JModelConfig
from repro.config.base import RunConfig as JRunConfig
from repro.config.base import TrainConfig as JTrainConfig
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.launch.steps import train_cell as j_train_cell
from repro.models import decode_step_paged as j_decode_step_paged
from repro.models import init_params as j_init_params
from repro.models import prefill_chunk as j_prefill_chunk
from repro.roofline.analysis import HW_V5E
from repro.roofline.analysis import compiled_costs as j_compiled_costs
from repro.roofline.analysis import model_bytes_for_cell as j_model_bytes
from repro.roofline.analysis import model_flops_for_cell as j_model_flops
from repro.roofline.analysis import roofline_report as j_roofline_report
from repro.roofline.hlo_cost import analyze_hlo_text
from repro.serve.pages import init_kv_pages as j_init_kv_pages

from repro_torch.config import SHAPES, get_arch, get_reduced
from repro_torch.config import base as tbase
from repro_torch.dist import collectives as C
from repro_torch.dist.hints import Mesh, dry_mesh
from repro_torch.launch.steps import build_cell, train_cell
from repro_torch.models.attention import attend_flash
from repro_torch.roofline import (
    HW_H100,
    counted_costs,
    kernel_costs,
    model_bytes_for_cell,
    model_flops_for_cell,
    roofline_report,
)

from conftest import ALL_ARCHS

torch.set_num_threads(4)

TOL = 0.05          # decode and chunk steps (tests/test_costs.py's)
TRAIN_TOL = 0.10
COST_SHAPES = [
    JModelConfig(name="a", family="dense", n_layers=2, d_model=128,
                 n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512),
    JModelConfig(name="b", family="dense", n_layers=3, d_model=256,
                 n_heads=8, n_kv_heads=4, d_ff=512, vocab_size=1024),
]
B, PAGE, NBLK, CHUNK = 4, 8, 4, 16


def _tcfg(cfg):
    return tbase.ModelConfig(**dataclasses.asdict(cfg))


def _cpu_mesh():
    return Mesh((1, 1), ("data", "model"), 0, torch.device("cpu"),
                {("data",): None, ("model",): None})


# ------------------------------------------------------------ counting
def test_single_dot_exact():
    r = counted_costs(lambda a, b: a @ b, torch.ones(128, 64),
                      torch.ones(64, 32))
    assert r["flops"] == 2 * 128 * 64 * 32


def _loop(x, n):
    for _ in range(n):
        x = x @ x
    return x


@pytest.mark.parametrize("length", [2, 5, 13])
def test_loop_counts_every_trip(length):
    one = counted_costs(_loop, torch.ones(64, 64), 1)["flops"]
    port = counted_costs(_loop, torch.ones(64, 64), length)["flops"]
    assert port == length * one == length * 2 * 64 ** 3
    comp = jax.jit(lambda x: jax.lax.scan(
        lambda c, _: (c @ c, None), x, None, length=length)[0]).lower(
            jnp.ones((64, 64))).compile()
    assert port == pytest.approx(analyze_hlo_text(comp.as_text())["flops"],
                                 rel=0.01)


def test_nested_loops_exact():
    def nested(x):
        for _ in range(5):
            x = _loop(x, 3)
        return x

    assert counted_costs(nested, torch.ones(32, 32))["flops"] == \
        15 * 2 * 32 ** 3


def test_bytes_scale_with_trips():
    def body(x, n):
        for _ in range(n):
            x = x @ x + 1.0
        return x

    two = counted_costs(body, torch.ones(64, 64), 2)["bytes"]
    eight = counted_costs(body, torch.ones(64, 64), 8)["bytes"]
    assert two > 0 and eight == 4 * two


def test_region_attribution():
    q = torch.ones(1, 128, 4, 16)
    k = torch.ones(1, 128, 2, 16)
    pos = torch.arange(128)[None]
    r = counted_costs(lambda q, k, v: attend_flash(q, k, v, pos, 0,
                                                   block_q=64, block_kv=64),
                      q, k, k)
    assert r["regions"]["attention"]["flops"] > 0.5 * r["flops"] > 0


# --------------------------------------------------------- collectives
def test_dry_mesh_tallies_every_family():
    mesh = dry_mesh((4, 2), ("data", "model"), rank=5)
    x = torch.empty(16, 16, device="meta")

    def fn(x):
        C.all_reduce(x, mesh.group("model"))
        C.all_reduce(x.to(torch.bfloat16), mesh.group("data"))
        g = C.all_gather(x, mesh.group("data"), 0)
        C.reduce_scatter(g, mesh.group("data"), 0)
        C.ppermute(x, mesh.group("model"))
        return g

    r = counted_costs(fn, x)["collectives"]
    assert r["all-reduce"] == 2 * 16 * 16 * 4   # bf16 summed in float32
    assert r["all-gather"] == 4 * 16 * 16 * 4
    assert r["reduce-scatter"] == 16 * 16 * 4
    assert r["collective-permute"] == 16 * 16 * 4
    assert r["all-to-all"] == 0
    assert r["total"] == sum(r[k] for k in (
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"))
    assert mesh.group("data").size == 4 and mesh.group("data").index == 2


# ------------------------------------------------------ report arithmetic
_HLO = """
HloModule m
ENTRY %main (a: f32[16,16]) -> f32[16,16] {
  %a = f32[16,16]{1,0} parameter(0)
  %d = f32[16,16]{1,0} dot(%a, %a), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ag = f32[64,16]{1,0} all-gather(%d), replica_groups={}
  %ar = f32[16,16]{1,0} all-reduce(%a), to_apply=%add
  %rs = f32[4,16]{1,0} reduce-scatter(%a), to_apply=%add
  ROOT %cp = f32[16,16]{1,0} collective-permute(%a)
}
"""


class _Stub:
    """A compiled artifact for JAX's ``roofline_report``: no XLA FLOPs (so
    the analyzer's count is the one used), the HLO above, a memory
    analysis."""

    class _Mem:
        argument_size_in_bytes = 1024
        output_size_in_bytes = 1024
        temp_size_in_bytes = 4096
        alias_size_in_bytes = 0

    def cost_analysis(self):
        return {"flops": 0.0, "bytes accessed": 0.0}

    def as_text(self):
        return _HLO

    def memory_analysis(self):
        return self._Mem()


@pytest.mark.parametrize("model_flops,model_bytes",
                         [(None, None), (2e4, 3e3), (1e9, 0.0)])
def test_report_arithmetic_matches_jax(model_flops, model_bytes):
    counted = analyze_hlo_text(_HLO)
    assert counted["collectives"]["total"] > 0
    counted["memory_analysis"] = {k: getattr(_Stub._Mem, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes")}
    want = j_roofline_report(_Stub(), 8, model_flops=model_flops,
                             model_bytes=model_bytes, hw=HW_V5E)
    got = roofline_report(counted, 8, model_flops=model_flops,
                          model_bytes=model_bytes, hw=HW_V5E)
    for key in ("n_devices", "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "regions", "compute_s",
                "memory_s", "collective_s", "dominant", "bound_seconds",
                "memory_analysis", "model_flops_total", "useful_flops_ratio",
                "ideal_compute_s", "ideal_memory_s", "roofline_fraction"):
        assert got.get(key) == want.get(key), key
    assert set(HW_H100) == set(HW_V5E)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_match_jax(arch):
    jc, tc = j_get_arch(arch), get_arch(arch)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


@pytest.mark.parametrize("bits", [0, 4, 8])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_and_bytes_match_jax(arch, bits):
    jc, tc = j_get_arch(arch), get_arch(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert model_flops_for_cell(tc, SHAPES[name]) == \
            j_model_flops(jc, J_SHAPES[name])
        for cache in (0.0, 3.5e9):
            assert model_bytes_for_cell(tc, SHAPES[name], bits, cache) == \
                j_model_bytes(jc, J_SHAPES[name], bits, cache)


# ------------------------------------------------------- kernel bounds
_HBM, _PEAK = HW_H100["hbm_bw"], HW_H100["peak_flops"]
_GEMV = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]
_SSM_GEMV = [(768, 3352), (1536, 768)]
_DECODE_CUR = [40, 77, 129, 166, 200, 251, 300, 331]
_PREFILL_POS0 = [0, 32, 64, 100, 150, 200, 250, 268]


def _prefill_keys_pairs():
    seq = [p + 32 for p in _PREFILL_POS0]
    seq[-1] = _PREFILL_POS0[-1] + 27          # a ragged last lane
    pairs = sum(q + 1 for p, s in zip(_PREFILL_POS0, seq)
                for q in range(p, p + 32) if q < s) * 16
    return sum(seq), pairs


def _bound_rows():
    """(row, cost, printed bound ms) for every bound of PERF.md's table."""
    rows = []
    for bits, m, printed in (
            (4, 8, "0.00065 0.00009 0.00344 0.00343"),
            (8, 8, "0.00127 0.00017 0.00681 0.00679"),
            (2, 8, "0.00034 0.00005 0.00176 0.00175"),
            (4, 2, "0.00063 0.00008 0.00339 0.00338"),
            (4, 256, "0.0022 0.0004 0.0117 0.0117"),
            (4, 8192, "0.0695 0.0113 0.3735 0.3735")):
        for (k, n), want in zip(_GEMV, printed.split()):
            rows.append((f"bitplane_gemv {bits}-bit M={m} {k}x{n}",
                         kernel_costs.bitplane_gemv(m, k, n, bits, 2), want))
    for m, printed in ((4, "0.00040 0.00018"), (16384, "0.0853 0.0391")):
        for (k, n), want in zip(_SSM_GEMV, printed.split()):
            rows.append((f"bitplane_gemv M={m} {k}x{n}",
                         kernel_costs.bitplane_gemv(m, k, n, 4, 2), want))
    for (k, n, experts, touched, rows_), want in (
            ((5120, 8192, 16, 5, 8), "0.0314"),
            ((8192, 5120, 16, 5, 8), "0.0314"),
            ((4096, 1536, 128, 57, 64), "0.0538"),
            ((1536, 4096, 128, 57, 64), "0.0540")):
        rows.append((f"grouped decode {k}x{n}",
                     kernel_costs.bitplane_gemv_grouped(rows_, k, n, 4,
                                                        touched), want))
    for (k, n, experts), want in (((5120, 8192, 16), "0.1085"),
                                  ((8192, 5120, 16), "0.1084"),
                                  ((4096, 1536, 128), "0.1480"),
                                  ((1536, 4096, 128), "0.1484")):
        rows.append((f"grouped chunk {k}x{n}",
                     kernel_costs.bitplane_gemv_grouped(
                         experts * 64, k, n, 4, experts), want))
    keys = sum(c + 1 for c in _DECODE_CUR)
    for kind, eb, scaled, want in (("int8", 1, True, "0.00026"),
                                   ("bf16", 2, False, "0.00049")):
        rows.append((f"paged decode {kind}",
                     kernel_costs.paged_decode_attention(
                         8, 2, 8, 128, 64, keys, eb, 2, scaled), want))
    keys, pairs = _prefill_keys_pairs()
    for kind, eb, scaled, dh, want in (
            ("int8", 1, True, 128, "0.00114"),
            ("bf16", 2, False, 128, "0.00134"),
            ("int8 D 320", 1, True, 320, "0.00285")):
        rows.append((f"paged prefill {kind}",
                     kernel_costs.paged_prefill_attention(
                         8, 32, 2, 8, dh, 64, keys, pairs, eb, 2, scaled),
                     want))
    for d, want in ((128, "0.139"), (320, "0.348"), (512, "0.556")):
        rows.append((f"flash D {d}",
                     kernel_costs.flash_attention(2, 4096, 16, 2, d, 2),
                     want))
    rows.append(("ssd_scan", kernel_costs.ssd_scan(4, 4096, 24, 64, 128, 256,
                                                   2, 4, 2), "0.049"))
    for m, printed in ((1, "0.00126 0.00016 0.00675 0.00674"),
                       (8, "0.00127 0.00017 0.00681 0.00679"),
                       (256, "0.00217 0.00051 0.01167 0.01167"),
                       (8192, "0.0695 0.0114 0.3735 0.3735")):
        for (k, n), want in zip(_GEMV, printed.split()):
            rows.append((f"int8_matvec M={m} {k}x{n}",
                         kernel_costs.int8_matvec(m, k, n, 2), want))
    return rows


_BOUND_ROWS = _bound_rows()


@pytest.mark.parametrize("row,cost,printed", _BOUND_ROWS,
                         ids=[r[0] for r in _BOUND_ROWS])
def test_kernel_bounds_of_the_table(row, cost, printed):
    n_bytes, n_ops = cost
    bound = max(n_bytes / _HBM, n_ops / _PEAK) * 1e3
    digits = len(printed.split(".")[1])
    assert round(bound, digits) == pytest.approx(float(printed), abs=1e-12)


# ----------------------------------------------------------- cpu = meta
@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("cell", ["paged_serve", "chunked_prefill"])
def test_cell_counts_the_same_on_cpu_and_meta(cell, kv_bits):
    cfg = get_reduced("qwen2.5-3b")
    kind, kw = (("decode", {"paged": True}) if cell == "paged_serve"
                else ("prefill", {"chunked": True}))
    eng = tbase.EngineConfig(weight_bits=4, kv_bits=kv_bits, backend="cuda",
                             attn_backend="cuda")
    run = tbase.RunConfig(model=cfg, shape=tbase.ShapeConfig(cell, kind, 64,
                                                             4),
                          serve=tbase.ServeConfig(engine=eng, page_size=8,
                                                  prefill_chunk=16))
    counts = {}
    for dev, mesh in (("cpu", _cpu_mesh()),
                      ("meta", dry_mesh((1, 1), ("data", "model")))):
        fn, args, _ = build_cell(run, mesh, abstract=dev == "meta",
                                 device=dev, **dict(kw))
        counts[dev] = counted_costs(fn, *args)
    for key in ("flops", "bytes", "transcendentals", "collectives",
                "priced"):
        assert counts["cpu"][key] == counts["meta"][key], key
    assert sum(counts["cpu"]["priced"].values()) == 3 * 8   # 7 GEMVs + attn
    cpu, meta = (counts[d]["memory_analysis"] for d in ("cpu", "meta"))
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert cpu[key] == meta[key] > 0


# ------------------------------------------------- against JAX compiled
def _paged_inputs(cfg, kv_bits):
    params = j_init_params(cfg, jax.random.PRNGKey(0))
    pages = j_init_kv_pages(cfg, B * NBLK + 1, PAGE, kv_bits=kv_bits)
    bt = jnp.arange(1, 1 + B * NBLK, dtype=jnp.int32).reshape(B, NBLK)
    return params, pages, bt


def _port_step(cfg, kv_bits, kind):
    from repro_torch.models.transformer import (decode_step_paged,
                                                init_params, prefill_chunk)
    from repro_torch.serve.pages import init_kv_pages

    tcfg = _tcfg(cfg)
    eng = (tbase.EngineConfig(kv_bits=8, backend="reference",
                              attn_backend="gather") if kv_bits else None)
    params = init_params(tcfg, torch.Generator().manual_seed(0))
    pages = init_kv_pages(tcfg, B * NBLK + 1, PAGE, kv_bits=kv_bits,
                          device="cpu")
    bt = torch.arange(1, 1 + B * NBLK, dtype=torch.int32).reshape(B, NBLK)
    if kind == "decode":
        return counted_costs(
            lambda *a: decode_step_paged(*a, tcfg, eng,
                                         attn_backend="gather"),
            params, pages, bt, torch.full((B,), 5, dtype=torch.int32),
            torch.ones(B, dtype=torch.bool),
            torch.zeros((B, 1), dtype=torch.int32))
    return counted_costs(
        lambda *a: prefill_chunk(*a, tcfg, eng, attn_backend="gather"),
        params, pages, bt, torch.zeros((B, CHUNK), dtype=torch.int32),
        torch.zeros(B, dtype=torch.int32),
        torch.full((B,), CHUNK, dtype=torch.int32))


@pytest.mark.parametrize("kind", ["decode", "chunk"])
@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("cfg", COST_SHAPES, ids=lambda c: c.name)
def test_step_flops_match_jax_compiled(cfg, kv_bits, kind):
    params, pages, bt = _paged_inputs(cfg, kv_bits)
    if kind == "decode":
        fn = jax.jit(functools.partial(j_decode_step_paged, cfg=cfg, eng=None,
                                       attn_backend="gather"))
        comp = fn.lower(params, pages, bt, jnp.full((B,), 5, jnp.int32),
                        jnp.ones((B,), bool),
                        jnp.zeros((B, 1), jnp.int32)).compile()
    else:
        fn = jax.jit(functools.partial(j_prefill_chunk, cfg=cfg, eng=None,
                                       attn_backend="gather"))
        comp = fn.lower(params, pages, bt, jnp.zeros((B, CHUNK), jnp.int32),
                        jnp.zeros((B,), jnp.int32),
                        jnp.full((B,), CHUNK, jnp.int32)).compile()
    want = j_compiled_costs(comp)["flops"]
    got = _port_step(cfg, kv_bits, kind)["flops"]
    assert 1 - TOL <= got / want <= 1 + TOL, (got, want)


def test_train_cell_flops_match_jax_compiled():
    cfg = COST_SHAPES[0]
    run = JRunConfig(model=cfg, shape=J_SHAPES["train_4k"].__class__(
        "t", "train", 64, 4), train=JTrainConfig())
    mesh = j_host_mesh()
    from repro.dist import use_mesh

    with use_mesh(mesh):
        fn, args = j_train_cell(run, mesh)
        want = j_compiled_costs(fn.lower(*args).compile())["flops"]
    trun = tbase.RunConfig(model=_tcfg(cfg),
                           shape=tbase.ShapeConfig("t", "train", 64, 4))
    fn, args = train_cell(trun, dry_mesh((1, 1), ("data", "model")))
    got = counted_costs(fn, *args)["flops"]
    assert 1 - TRAIN_TOL <= got / want <= 1 + TRAIN_TOL, (got, want)
    assert np.isfinite(got) and got > 0
