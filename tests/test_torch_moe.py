"""PyTorch port vs JAX: the MoE family (reduced qwen3-moe-235b-a22b and
llama4-scout-17b-a16e, float32).

Both packages get the same weights (JAX ``init_moe`` / ``init_params``,
packed by JAX where the engine packs, handed to the port through numpy)
and the same inputs, made from a seed with numpy.

- ``moe_block`` at ``capacity_factor`` 8.0 (nothing dropped) and 1.25 with
  a router skewed towards expert 0 (pairs dropped), dense, 4- and 8-bit
  experts, ``(B, S, D)`` and ``(T, D)`` inputs: y within rtol = atol =
  1e-5 (float32 sums in another order: JAX multiplies an ``(E, C, D)``
  buffer, the port a grouped block of rows), aux within 1e-6, and the kept
  and dropped (token, slot) pairs exactly JAX's;
- the grouped GEMV's plain version and the ``reference`` / ``bit_serial``
  grouped backends against JAX's ``reference`` backend on stacked weights
  (an empty expert, one expert with every row, ragged counts) within
  1e-5;
- ``params_from_numpy`` giving JAX's stacked codes byte for byte, the
  port's ``pack_linear`` on a stacked weight giving JAX's bytes, and
  ``obs.linear_specs`` equal to JAX's;
- ``prefill_chunk`` / ``decode_step_paged`` logits against JAX's (gather
  attention) at rtol = atol = 1e-4 with full-precision pages;
- checkpoints of stacked expert linears across the two packages, bytes
  equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import EngineConfig
from repro.engine import resolve_plan
from repro.engine.backends import _reference as jax_reference
from repro.models import decode_step_paged, init_params, prefill_chunk
from repro.models.layers import dense as jdense
from repro.models.moe import _capacity as j_capacity
from repro.models.moe import init_moe
from repro.models.moe import moe_block as j_moe_block
from repro.models.transformer import quantize_params
from repro.obs.costs import linear_specs as j_linear_specs
from repro.ckpt import load_checkpoint as j_load, save_checkpoint as j_save
from repro.serve import PageAllocator, init_kv_pages

import repro_torch.config as tconfig
import repro_torch.models as tmodels
import repro_torch.obs as tobs
import repro_torch.serve as tserve
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.engine import get_grouped_backend, pack_linear
from repro_torch.engine import resolve_plan as t_resolve_plan
from repro_torch.kernels.bitplane_gemv import bitplane_gemv_grouped
from repro_torch.models.moe import _capacity, max_expert_rows, moe_block
from repro_torch.models.moe import route as t_route
from repro_torch.weights import _convert, params_from_numpy

from conftest import reduced_f32
from test_torch_model import jax_params_to_numpy, torch_cfg

torch.set_num_threads(1)

ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]
Y_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
# int8 pages: both packages round q and p * s_v to bf16, so a last-bit
# difference upstream (a float32 sum in another order, XLA's exp against
# PyTorch's) can move a rounding by one bf16 ulp; the tolerance of
# tests/test_torch_model.py's int8 cases, KV8_TOL, states the same cause
KV8_MOE_TOL = dict(rtol=1e-3, atol=1e-3)


def _moe_params(arch, cf, bits, skew):
    cfg = reduced_f32(arch, capacity_factor=cf)
    p = init_moe(jax.random.PRNGKey(1), cfg, jnp.float32)
    if skew:
        w = np.array(p["router"]["w"])
        w[:, 0] += 0.5            # most tokens want expert 0: pairs drop
        p["router"]["w"] = jnp.asarray(w)
    if bits:
        p = quantize_params({"moe": p}, cfg, bits)["moe"]
    return cfg, p


def _jax_keep(p, x, cfg):
    """JAX's kept mask in (token, slot) order, computed as
    ``repro.models.moe.moe_block`` computes it (stable sort by expert, rank
    against the row's capacity)."""
    b, s, _ = x.shape
    k = cfg.top_k
    probs = jax.nn.softmax(jdense(p["router"], x).astype(jnp.float32), -1)
    _, top_i = jax.lax.top_k(probs, k)
    flat_e = top_i.reshape(b, s * k)
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=-1)
    starts = jax.vmap(lambda r: jnp.searchsorted(r, jnp.arange(
        cfg.n_experts)))(sorted_e)
    rank = (jnp.arange(s * k)[None]
            - jnp.take_along_axis(starts, sorted_e, axis=-1))
    keep_sorted = rank < j_capacity(s, cfg)
    keep = jnp.zeros((b, s * k), bool).at[jnp.arange(b)[:, None],
                                           order].set(keep_sorted)
    return np.asarray(keep).reshape(b, s, k), np.asarray(top_i)


def _port_moe(p, cfg, bits):
    tp = _convert(jax_params_to_numpy(p), None, "cpu", None)
    plan = t_resolve_plan(tconfig.EngineConfig(weight_bits=bits),
                          device="cpu")
    return tp, torch_cfg(cfg), plan


@pytest.mark.parametrize("bits", [0, 4, 8])
@pytest.mark.parametrize("cf,skew", [(8.0, False), (1.25, True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, cf, skew, bits):
    cfg, p = _moe_params(arch, cf, bits, skew)
    x = np.random.default_rng(0).standard_normal(
        (3, 20, cfg.d_model)).astype(np.float32)
    ecfg = EngineConfig(weight_bits=bits, backend="reference")
    jy, jaux = j_moe_block(p, jnp.asarray(x), cfg, ecfg if bits else None)
    tp, tcfg, plan = _port_moe(p, cfg, bits)
    ty, taux = moe_block(tp, torch.from_numpy(x), tcfg, plan)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **Y_TOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    jkeep, jtop = _jax_keep(p, jnp.asarray(x), cfg)
    _, ttop, tkeep, _ = t_route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(ttop.numpy(), jtop)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    assert (not jkeep.all()) == skew      # the skewed router drops pairs


@pytest.mark.parametrize("bits", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_2d_input_matches_jax(arch, bits):
    cfg, p = _moe_params(arch, 1.25, bits, True)
    x = np.random.default_rng(1).standard_normal(
        (24, cfg.d_model)).astype(np.float32)
    ecfg = EngineConfig(weight_bits=bits, backend="reference")
    jy, jaux = j_moe_block(p, jnp.asarray(x), cfg, ecfg if bits else None)
    tp, tcfg, plan = _port_moe(p, cfg, bits)
    ty, taux = moe_block(tp, torch.from_numpy(x), tcfg, plan)
    assert ty.shape == x.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **Y_TOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_rows_stay_within_the_static_bound(arch, seed):
    """``max_expert_rows`` bounds every expert's kept rows whatever the
    routing (a skewed router at a large capacity factor fills one expert
    to the bound)."""
    cfg, p = _moe_params(arch, 8.0, 0, seed % 2 == 1)
    tp, tcfg, _ = _port_moe(p, cfg, 0)
    b, s = 4, 1 + 9 * seed
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))
    counts = torch.zeros(cfg.n_experts, dtype=torch.int32)
    moe_block(tp, x, tcfg, None, counts)
    _, experts, keep, _ = t_route(tp, x, tcfg)
    want = torch.bincount(experts[keep], minlength=cfg.n_experts)
    assert torch.equal(counts, want.int())
    assert int(counts.max()) <= max_expert_rows(b, s, tcfg)
    assert max_expert_rows(b, s, tcfg) == b * min(_capacity(s, tcfg), s)


def _grouped_case(bits, counts, k=64, n=40, seed=0):
    rng = np.random.default_rng(seed)
    e = len(counts)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    lin = pack_linear(torch.from_numpy(w), bits)
    r = sum(counts)
    x = rng.standard_normal((max(r, 1) + 3, k)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return lin, x, offsets


# an empty expert, one expert holding every row, ragged counts
GROUPED_COUNTS = [(0, 5, 0, 3), (0, 0, 9, 0), (3, 1, 4, 1, 5, 9, 2, 6)]


@pytest.mark.parametrize("counts", GROUPED_COUNTS, ids=str)
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_grouped_gemv_matches_jax_reference(bits, counts):
    """Each expert's rows against JAX's ``reference`` backend on the
    stacked weights, applied as JAX's MoE applies it (an ``(E, C, K)``
    buffer of each expert's rows)."""
    lin, x, offsets = _grouped_case(bits, counts)
    max_rows = max(counts)
    jlin = jax.tree.map(jnp.asarray, dict(packed=lin.packed.numpy(),
                                          scale=lin.scale.numpy()))
    from repro.engine.packed import PackedLinear as JPacked
    jp = JPacked(jlin["packed"], jlin["scale"], None, bits,
                 lin.in_features, lin.out_features)
    buf = np.zeros((len(counts), max_rows, x.shape[1]), np.float32)
    for e, c in enumerate(counts):
        buf[e, :c] = x[offsets[e]:offsets[e] + c]
    jy = np.asarray(jax_reference(None, jp, jnp.asarray(buf), jnp.float32))
    want = np.zeros((x.shape[0], lin.out_features), np.float32)
    for e, c in enumerate(counts):
        want[offsets[e]:offsets[e] + c] = jy[e, :c]
    xt, off = torch.from_numpy(x), torch.from_numpy(offsets)
    got = {"ops": bitplane_gemv_grouped(lin.packed, lin.scale, xt, off,
                                        max_rows=max_rows, bits=bits)}
    for name in ("reference", "bit_serial"):
        plan = t_resolve_plan(tconfig.EngineConfig(weight_bits=bits,
                                                   backend=name),
                              device="cpu")
        got[name] = get_grouped_backend(name)(plan, lin, xt, off, max_rows,
                                              torch.float32)
        assert torch.equal(plan.apply_grouped(lin, xt, off, max_rows),
                           got[name])
    rows = int(offsets[-1])
    for name, y in got.items():
        np.testing.assert_allclose(y[:rows].numpy(), want[:rows], **Y_TOL,
                                   err_msg=name)
        assert not y[rows:].any(), name     # the plain forms zero the rest


def test_apply_grouped_refuses_flat_weights():
    lin, x, offsets = _grouped_case(4, (2, 2))
    plan = t_resolve_plan(tconfig.EngineConfig(weight_bits=4), device="cpu")
    flat = pack_linear(torch.randn(64, 40), 4)
    with pytest.raises(ValueError, match="stacked"):
        plan.apply_grouped(flat, torch.from_numpy(x),
                           torch.from_numpy(offsets), 2)


@functools.lru_cache(maxsize=None)
def _model(arch, bits):
    cfg = reduced_f32(arch)
    params = init_params(cfg, jax.random.PRNGKey(0))
    if bits:
        params = quantize_params(params, cfg, bits)
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    return cfg, params, tcfg, tparams


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_codes_are_jax_bytes(arch, bits):
    cfg, params, tcfg, tparams = _model(arch, bits)
    raw = init_params(cfg, jax.random.PRNGKey(0))
    for name in ("w_gate", "w_up", "w_down"):
        jlin = params["layers"]["moe"][name]
        for layer in range(cfg.n_layers):
            tlin = tparams["layers"][layer]["moe"][name]
            assert tlin.packed.shape == (cfg.n_experts,) + tuple(
                jlin.packed.shape[2:])
            np.testing.assert_array_equal(tlin.packed.numpy(),
                                          np.asarray(jlin.packed[layer]))
            np.testing.assert_array_equal(tlin.scale.numpy(),
                                          np.asarray(jlin.scale[layer]))
            # the port's own packing of the stacked float weight
            mine = pack_linear(torch.from_numpy(np.array(
                raw["layers"]["moe"][name][layer])), bits)
            assert torch.equal(mine.packed, tlin.packed)
            assert torch.equal(mine.scale, tlin.scale)
    # the router stays dense, as in JAX
    assert "w" in tparams["layers"][0]["moe"]["router"]
    # port quantize_params of the float tree packs the same bytes
    _, _, _, dense = _model(arch, 0)
    packed = tmodels.quantize_params(dense, tcfg, bits)
    for name in ("w_gate", "w_up", "w_down"):
        assert torch.equal(packed["layers"][1]["moe"][name].packed,
                           tparams["layers"][1]["moe"][name].packed)


def _spec_set(specs):
    return sorted((s.name, s.in_features, s.out_features, s.bits, s.stack,
                   s.bias, s.partition, s.weight_itemsize) for s in specs)


@pytest.mark.parametrize("bits", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_linear_specs_equal_jax(arch, bits):
    cfg, params, _, tparams = _model(arch, bits)
    assert (_spec_set(tobs.linear_specs(tparams))
            == _spec_set(j_linear_specs(params)))


def test_routed_costs_price_the_touched_experts():
    _, _, tcfg, tparams = _model("qwen3-moe-235b-a22b", 4)
    specs = tobs.linear_specs(tparams)
    table = tobs.decode_step_costs(tobs.model_dims(tcfg), batch=4,
                                   context=64, page_size=8, specs=specs)
    every = tcfg.n_layers * tcfg.n_experts
    assert tobs.routed_costs(table, specs, touched=every) == table
    none = tobs.routed_costs(table, specs, touched=0)
    experts = [s.key for s in specs if s.name.endswith(tobs.costs.
                                                       EXPERT_LINEARS)]
    assert len(experts) == 3
    for key in table:
        want = 0.0 if key in experts else table[key].bytes
        assert none[key].bytes == want, key
    half = tobs.total_cost(tobs.routed_costs(table, specs,
                                             touched=every / 2)).bytes
    assert half == pytest.approx(
        (tobs.total_cost(table).bytes
         + tobs.total_cost(none).bytes) / 2)


# ------------------------------------------------ paged steps against JAX
@pytest.mark.parametrize("bits,kv_bits", [(0, 0), (4, 0), (4, 8)])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_steps_match_jax(arch, bits, kv_bits):
    """Ragged chunks with an idle lane, then decode steps with that lane
    inactive: the logits of JAX's ``prefill_chunk`` / ``decode_step_paged``
    (gather attention, reference GEMV), and the port's rows per expert
    summing to every layer's kept pairs."""
    cfg, params, tcfg, tparams = _model(arch, bits)
    ecfg = dict(weight_bits=bits, kv_bits=kv_bits, backend="reference",
                attn_backend="gather")
    plan = resolve_plan(EngineConfig(**ecfg))
    tplan = t_resolve_plan(tconfig.EngineConfig(**ecfg), device="cpu")
    tol = KV8_MOE_TOL if kv_bits else STEP_TOL
    page, chunk, b, max_len = 4, 5, 3, 24
    n_pages = b * (max_len // page) + 1
    alloc = PageAllocator(n_pages, page, b, max_len)
    lens = [11, 7, 0]                     # lane 2 stays idle throughout
    for lane, n in enumerate(lens):
        if n:
            assert alloc.ensure(lane, n + 4)
    bt_np = alloc.block_tables.copy()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    jpages = init_kv_pages(cfg, n_pages, page, kv_bits=kv_bits)
    tpages = tserve.init_kv_pages(tcfg, n_pages, page, kv_bits=kv_bits,
                                  device="cpu")
    bt_j, bt_t = jnp.asarray(bt_np), torch.from_numpy(bt_np)
    counts = torch.zeros((tcfg.n_layers, tcfg.n_experts), dtype=torch.int32)

    done = np.zeros(b, np.int64)
    while any(done[i] < lens[i] for i in range(b)):   # ragged last chunks
        toks = np.zeros((b, chunk), np.int32)
        pos0, seq = done.astype(np.int32), done.astype(np.int32)
        for i in range(b):
            n = min(chunk, lens[i] - done[i])
            toks[i, :n] = prompts[i][done[i]:done[i] + n]
            seq[i] = done[i] + n
        jl, jpages = prefill_chunk(params, jpages, bt_j, jnp.asarray(toks),
                                   jnp.asarray(pos0), jnp.asarray(seq), cfg,
                                   plan, attn_backend="gather")
        tl = tmodels.prefill_chunk(
            tparams, tpages, bt_t, torch.from_numpy(toks),
            torch.from_numpy(pos0), torch.from_numpy(seq), tcfg, tplan,
            attn_backend="gather", expert_counts=counts)
        live = [i for i in range(b) if seq[i] > pos0[i]]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **tol)
        # every position routes, the padding too; none dropped at chunk 5
        assert torch.equal(counts.sum(1), torch.full(
            (tcfg.n_layers,), b * chunk * tcfg.top_k))
        done = seq.astype(np.int64)

    pos = np.asarray(lens, np.int32)
    active = np.asarray([n > 0 for n in lens])
    for step in range(3):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jpages = decode_step_paged(
            params, jpages, bt_j, jnp.asarray(pos), jnp.asarray(active),
            jnp.asarray(toks), cfg, plan, attn_backend="gather")
        tl = tmodels.decode_step_paged(
            tparams, tpages, bt_t, torch.from_numpy(pos),
            torch.from_numpy(active), torch.from_numpy(toks), tcfg, tplan,
            attn_backend="gather", expert_counts=counts)
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], **tol)
        # a token's k experts are distinct: every lane's pairs are kept
        assert torch.equal(counts.sum(1), torch.full(
            (tcfg.n_layers,), b * tcfg.top_k))
        pos = pos + active


# ------------------------------------------------------- checkpoints
def _moe_tree(bits=4):
    cfg, p = _moe_params("qwen3-moe-235b-a22b", 1.25, bits, False)
    return cfg, {"moe": p, "step": jnp.asarray(3, jnp.int32)}


def _port_tree(jtree, zero=False):
    tp = _convert(jax_params_to_numpy(jtree["moe"]), None, "cpu", None)
    if zero:
        return {"moe": _zeros(tp), "step": torch.zeros((), dtype=torch.int32)}
    return {"moe": tp, "step": torch.tensor(3, dtype=torch.int32)}


def _zeros(node):
    if isinstance(node, dict):
        return {k: _zeros(v) for k, v in node.items()}
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, packed=torch.zeros_like(node.packed),
                                   scale=torch.zeros_like(node.scale))
    return torch.zeros_like(node)


def test_jax_writes_stacked_experts_port_reads(tmp_path):
    _, jtree = _moe_tree()
    j_save(str(tmp_path), 2, jtree)
    out, _ = load_checkpoint(str(tmp_path), _port_tree(jtree, zero=True))
    want = _port_tree(jtree)
    for name in ("w_gate", "w_up", "w_down"):
        got, ref = out["moe"][name], want["moe"][name]
        assert got.packed.shape == ref.packed.shape
        assert got.packed.ndim == 3
        assert torch.equal(got.packed, ref.packed), name
        assert torch.equal(got.scale, ref.scale), name
        assert (got.bits, got.in_features) == (ref.bits, ref.in_features)
    assert torch.equal(out["moe"]["router"]["w"], want["moe"]["router"]["w"])


def test_port_writes_stacked_experts_jax_reads(tmp_path):
    _, jtree = _moe_tree()
    save_checkpoint(str(tmp_path), 5, _port_tree(jtree))
    out, _ = j_load(str(tmp_path), jax.tree.map(jnp.zeros_like, jtree))
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the same leaf paths in both packages
    from repro.ckpt.checkpoint import _leaf_paths as j_paths
    from repro_torch.ckpt.checkpoint import _leaf_paths as t_paths
    assert t_paths(_port_tree(jtree))[0] == j_paths(jtree)[0]


def test_engine_counts_touched_experts():
    """A paged MoE engine keeps, for every step, the experts it touched
    summed over layers: between 1 and E a layer, and at decode at most
    lanes x k a layer."""
    _, _, tcfg, tparams = _model("llama4-scout-17b-a16e", 4)
    eng = tserve.ServeEngine(
        tcfg, tparams, tconfig.ServeConfig(
            max_new_tokens=4, engine=tconfig.EngineConfig(weight_bits=4)),
        n_slots=2, max_len=32, page_size=4, prefill_chunk=4, device="cpu")
    for prompt in ([1, 2, 3, 4, 5, 6], [7, 8], [9]):
        eng.submit(prompt)
    eng.run()
    touched = eng.experts_touched
    assert len(touched["decode"]) == len(eng.timings["decode"])
    assert len(touched["prefill"]) == len(eng.timings["prefill"])
    top = tcfg.n_layers * min(tcfg.n_experts, 2 * tcfg.top_k)
    assert all(tcfg.n_layers <= t <= top for t in touched["decode"])
    assert all(tcfg.n_layers <= t <= tcfg.n_layers * tcfg.n_experts
               for t in touched["prefill"])
