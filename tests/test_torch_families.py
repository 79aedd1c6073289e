"""PyTorch port vs JAX: the vlm, audio and hybrid families (reduced
llava-next-mistral-7b, musicgen-medium and zamba2-7b, float32).

Both packages get the same weights (JAX ``init_params(cfg,
PRNGKey(0))``, packed by JAX where the engine packs, handed to the port
through numpy and ``params_from_numpy``) and the same inputs, made from a
seed with numpy: token ids (``(B, S, K)`` codebook streams for musicgen)
and, for llava, ``img_embeds`` prepended to the text.

- the configs equal JAX's, and ``layer_kinds`` / ``uses_attention`` /
  ``is_subquadratic`` of all ten;
- ``forward``, one-shot ``prefill`` and greedy ``decode_step`` s against
  JAX's (the counterparts of ``tests/test_decode_equivalence.py``'s
  zamba2, musicgen and VLM cases): logits and caches within rtol = atol =
  1e-4, the same greedy tokens; ``forward`` also at a flash threshold
  lowered to 16 tokens, on both sequence-mixer routes (``gather`` and the
  kernels' plain versions behind ``cuda``); zamba2's prefill against
  sequential decode, llava's prefill against ``forward``;
- packed bytes, the hybrid family's shared block and musicgen's ``V·K``
  head included, equal JAX's;
- paged ``ServeEngine`` for llava and musicgen against JAX's ``gather``
  serve path: greedy tokens equal, final logits within 1e-4 with
  full-precision pages and within ``DENSE_KV8_TOL`` (atol 5e-3) with
  int8 pages, the tolerance ``tests/test_torch_serve.py`` states for
  int8 pages whose bf16 roundings of ``p * s_v`` fall the other way (here
  one request of five moves by 1.8e-3 at float32 and at 4-bit weights,
  the others by 2e-6); musicgen with the prefix cache
  (keyed on the single id: JAX's stats, the cold run's tokens) and with the
  budget scheduler; musicgen's paged tokens equal its slots tokens;
- zamba2 in slots mode against JAX (tokens, final logits within 1e-4),
  ``auto``'s fallback warning equal to JAX's, and ``mode="paged"``
  refused with JAX's ``ValueError``;
- the cost ledger's tables for musicgen equal JAX's op by op.
"""

import dataclasses
import functools
import logging
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jt
from repro.config.base import EngineConfig as JaxEngineConfig
from repro.config.base import ServeConfig as JaxServeConfig
from repro.models import decode_step, forward, init_cache, init_params
from repro.models.transformer import prefill, quantize_params
from repro.obs import costs as jcosts
from repro.serve import ServeEngine as JaxServeEngine

import repro_torch.config as tconfig
import repro_torch.models as tmodels
import repro_torch.models.transformer as tt
from repro_torch.engine import resolve_plan as t_resolve_plan
from repro_torch.obs import costs as tcosts
from repro_torch.serve import ServeEngine
from repro_torch.weights import params_from_numpy

from conftest import ALL_ARCHS, reduced_f32
from test_torch_model import jax_params_to_numpy, torch_cfg
from test_torch_serve import DENSE_KV8_TOL

torch.set_num_threads(1)

ARCHS = ["llava-next-mistral-7b", "musicgen-medium", "zamba2-7b"]
PAGED_ARCHS = ARCHS[:2]
TOL = dict(rtol=1e-4, atol=1e-4)
# S a multiple of zamba2's reduced ssm_chunk (16), as JAX's ssd_chunked
# needs
B, S, N_DECODE = 2, 16, 4
PROMPTS = [[1, 2, 3], [4], [5, 6, 7, 8, 9], [7, 8, 9, 10], [11, 3, 5]]
PORT_LOGGER = "repro_torch.serve.engine"


@functools.lru_cache(maxsize=None)
def _jax_model(arch, weight_bits):
    cfg = reduced_f32(arch)
    params = init_params(cfg, jax.random.PRNGKey(0))
    eng = None
    if weight_bits:
        params = quantize_params(params, cfg, weight_bits)
        eng = JaxEngineConfig(weight_bits=weight_bits, backend="reference")
    return cfg, params, eng


@functools.lru_cache(maxsize=None)
def _port_model(arch, weight_bits):
    cfg, params, _ = _jax_model(arch, weight_bits)
    tcfg = torch_cfg(cfg)
    tparams = params_from_numpy(jax_params_to_numpy(params), tcfg,
                                device="cpu")
    plan = t_resolve_plan(tconfig.EngineConfig(
        weight_bits=weight_bits, backend="reference"), device="cpu")
    return tcfg, tparams, plan


def _inputs(cfg, seed=1, s=S):
    """Token ids ``(B, s)`` (``(B, s, K)`` for audio) and, for the vlm,
    ``img_embeds`` ``(B, img_tokens, D)``, as numpy."""
    rng = np.random.default_rng(seed)
    shape = (B, s, cfg.n_codebooks) if cfg.family == "audio" else (B, s)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.standard_normal(
            (B, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _max_len(cfg):
    return S + cfg.img_tokens + N_DECODE + 4


def _greedy(logits):
    """Next tokens ``(B, 1)`` (``(B, 1, K)`` for audio) from last-token
    logits ``(B, 1, V)`` / ``(B, 1, K, V)``."""
    return np.argmax(np.asarray(logits)[:, -1], -1)[:, None].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, weight_bits, threshold=4096):
    cfg, params, eng = _jax_model(arch, weight_bits)
    batch = _jax_batch(_inputs(cfg))
    with mock.patch.object(jt, "FLASH_THRESHOLD", threshold):
        logits, _ = jax.jit(functools.partial(
            forward, cfg=cfg, eng=eng, remat="none"))(params, batch)
        if threshold != 4096:
            return dict(forward=np.asarray(logits))
        cache = init_cache(cfg, B, _max_len(cfg))
        pl, cache = jax.jit(functools.partial(prefill, cfg=cfg, eng=eng))(
            params, batch, cache=cache)
    out = dict(forward=np.asarray(logits), prefill=np.asarray(pl),
               prefill_cache={k: np.asarray(v) for k, v in cache.items()},
               decode=[], tokens=[])
    dec = jax.jit(functools.partial(decode_step, cfg=cfg, eng=eng))
    nxt = _greedy(pl)
    for _ in range(N_DECODE):
        out["tokens"].append(nxt)
        lg, cache = dec(params, cache, jnp.asarray(nxt))
        out["decode"].append(np.asarray(lg))
        nxt = _greedy(lg)
    out["final_cache"] = {k: np.asarray(v) for k, v in cache.items()}
    return out


def _assert_cache_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for key, ref in jcache.items():
        np.testing.assert_allclose(tcache[key].numpy(), ref, **TOL,
                                   err_msg=key)


# ------------------------------------------------------------ configs
def test_port_registry_holds_the_last_three_configs():
    """The three config files equal the JAX package's, published and
    reduced, and the port's ModelConfig derives every config's layer
    kinds, attention use and subquadratic flag as JAX's does."""
    from repro.config import get_arch as j_get_arch, get_reduced as j_red

    for arch in ARCHS:
        for mine, ref in ((tconfig.get_arch(arch), j_get_arch(arch)),
                          (tconfig.get_reduced(arch), j_red(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
    for arch in ALL_ARCHS:
        for mine, ref in ((tconfig.get_arch(arch), j_get_arch(arch)),
                          (tconfig.get_reduced(arch), j_red(arch))):
            assert mine.layer_kinds() == ref.layer_kinds(), arch
            assert mine.uses_attention == ref.uses_attention, arch
            assert mine.is_subquadratic == ref.is_subquadratic, arch


# ---------------------------------------------- the full-sequence path
@pytest.mark.parametrize("threshold,route", [(4096, "gather"),
                                             (16, "gather"), (16, "cuda")])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, threshold, route, monkeypatch):
    """``forward`` logits (``(B, S, K, V)`` for musicgen; llava's text
    positions after its image embeddings) within TOL of JAX's, below and
    at a lowered flash threshold, on both routes (``cuda`` on the CPU: the
    flash and SSD kernels' plain versions behind their wrappers)."""
    ref = _jax_run(arch, 0, threshold)
    tcfg, tparams, _ = _port_model(arch, 0)
    monkeypatch.setattr(tt, "FLASH_THRESHOLD", threshold)
    batch = _port_batch(_inputs(tcfg))
    logits, aux = tmodels.forward(tparams, batch, tcfg, attn_backend=route)
    assert logits.shape == ref["forward"].shape
    np.testing.assert_allclose(logits.numpy(), ref["forward"], **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch,weight_bits", [
    ("llava-next-mistral-7b", 0), ("musicgen-medium", 0),
    ("musicgen-medium", 4), ("zamba2-7b", 0), ("zamba2-7b", 4)])
def test_prefill_and_decode_match_jax(arch, weight_bits):
    """One-shot ``prefill`` (llava with its image positions in the cache)
    and greedy ``decode_step`` s against JAX's: logits and caches (the
    hybrid's conv, h and per-site K/V) within TOL, the same tokens; at
    4-bit weights for the two whose packing differs from the dense
    family's (zamba2's shared block, musicgen's ``V·K`` head)."""
    ref = _jax_run(arch, weight_bits)
    tcfg, tparams, plan = _port_model(arch, weight_bits)
    cache = tmodels.init_cache(tcfg, B, _max_len(tcfg), device="cpu")
    logits, cache = tmodels.prefill(tparams, _port_batch(_inputs(tcfg)),
                                    tcfg, cache, plan)
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], **TOL)
    _assert_cache_close(cache, ref["prefill_cache"])
    assert int(cache["pos"][0]) == S + tcfg.img_tokens * (
        tcfg.family == "vlm")
    nxt = _greedy(logits)
    for step in range(N_DECODE):
        np.testing.assert_array_equal(nxt, ref["tokens"][step])
        logits, cache = tmodels.decode_step(tparams, cache,
                                            torch.from_numpy(nxt), tcfg, plan)
        np.testing.assert_allclose(logits.numpy(), ref["decode"][step],
                                   **TOL)
        nxt = _greedy(logits)
    _assert_cache_close(cache, ref["final_cache"])


def test_hybrid_prefill_matches_sequential_decode():
    """zamba2: one-shot ``prefill`` equals the prompt decoded token by
    token, and the next step from either cache agrees (JAX's
    ``test_prefill_matches_sequential_decode``)."""
    tcfg, tparams, _ = _port_model("zamba2-7b", 0)
    toks = torch.from_numpy(_inputs(tcfg, seed=3)["tokens"])
    cache_p = tmodels.init_cache(tcfg, B, S + 6, device="cpu")
    lp, cache_p = tmodels.prefill(tparams, {"tokens": toks}, tcfg, cache_p)
    cache_s = tmodels.init_cache(tcfg, B, S + 6, device="cpu")
    for i in range(S):
        ls, cache_s = tmodels.decode_step(tparams, cache_s, toks[:, i:i + 1],
                                          tcfg)
    torch.testing.assert_close(ls, lp, **TOL)
    nxt = torch.argmax(lp[:, -1], -1)[:, None]
    l1, _ = tmodels.decode_step(tparams, cache_p, nxt, tcfg)
    l2, _ = tmodels.decode_step(tparams, cache_s, nxt, tcfg)
    torch.testing.assert_close(l1, l2, **TOL)
    assert cache_p["k"].shape[0] == tcfg.n_layers // tcfg.attn_every


def test_vlm_prefill_matches_forward():
    """llava: ``prefill``'s last logits equal ``forward``'s last text
    position, and decoding goes on from the image + text cache (JAX's
    ``test_vlm_prefill_matches_forward``)."""
    tcfg, tparams, _ = _port_model("llava-next-mistral-7b", 0)
    batch = _port_batch(_inputs(tcfg, seed=4))
    lf, _ = tmodels.forward(tparams, batch, tcfg)
    cache = tmodels.init_cache(tcfg, B, S + tcfg.img_tokens + 2,
                               device="cpu")
    lp, cache = tmodels.prefill(tparams, batch, tcfg, cache)
    torch.testing.assert_close(lf[:, -1:], lp, **TOL)
    nxt = torch.argmax(lp[:, -1], -1)[:, None]
    lg, _ = tmodels.decode_step(tparams, cache, nxt, tcfg)
    assert bool(torch.isfinite(lg).all())


# ------------------------------------------------------ packed bytes
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("arch", ["zamba2-7b", "musicgen-medium"])
def test_packed_bytes_equal_jax(arch, bits):
    """The port's ``quantize_params`` of the float tree packs every linear
    JAX's whole-tree walk packs, to JAX's bytes: the hybrid's shared block
    and ssm projections, musicgen's ``V·K`` head; the ``(K, V, D)``
    embedding stays dense."""
    cfg, jparams, _ = _jax_model(arch, bits)
    tcfg, dense, _ = _port_model(arch, 0)
    packed = tmodels.quantize_params(dense, tcfg, bits)
    want = params_from_numpy(jax_params_to_numpy(jparams), tcfg,
                             device="cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    got, ref = dict(leaves(packed)), dict(leaves(want))
    assert set(got) == set(ref)
    n_packed = 0
    for name, r in ref.items():
        g = got[name]
        if hasattr(r, "packed"):
            n_packed += 1
            assert (g.bits, g.in_features, g.out_features) == (
                r.bits, r.in_features, r.out_features), name
            assert torch.equal(g.packed, r.packed), name
            assert torch.equal(g.scale, r.scale), name
        else:
            assert torch.equal(g, r), name
    if arch == "zamba2-7b":
        for name in ("wq", "wk", "wv", "wo"):
            assert hasattr(packed["shared_attn"]["attn"][name], "packed")
        assert n_packed == 2 * tcfg.n_layers + 7 + 1
    else:
        assert packed["embed"].shape == (tcfg.n_codebooks, tcfg.vocab_size,
                                         tcfg.d_model)
        assert packed["lm_head"].out_features == (tcfg.vocab_size
                                                  * tcfg.n_codebooks)


def test_init_params_draws_each_family_shape():
    """The port's own init: the audio family's per-codebook embeddings
    and ``V·K`` head, the hybrid's shared block and every untied head
    packed as drawn (dense without ``engine_bits``)."""
    gen = torch.Generator().manual_seed(0)
    mg = tconfig.get_reduced("musicgen-medium")
    p = tmodels.init_params(mg, gen, engine_bits=4)
    assert p["embed"].shape == (mg.n_codebooks, mg.vocab_size, mg.d_model)
    assert p["lm_head"].bits == 4
    assert p["lm_head"].out_features == mg.vocab_size * mg.n_codebooks
    assert tmodels.init_params(mg, gen)["lm_head"]["w"].shape == (
        mg.d_model, mg.vocab_size * mg.n_codebooks)
    zb = tconfig.get_reduced("zamba2-7b")
    p = tmodels.init_params(zb, gen, engine_bits=4)
    assert hasattr(p["shared_attn"]["mlp"]["w_down"], "packed")
    assert p["lm_head"].bits == 4
    assert p["lm_head"].out_features == zb.vocab_size
    assert "ssm" in p["layers"][0] and "attn" not in p["layers"][0]


# -------------------------------------------------------- paged serving
def _engine(pkg, arch, *, weight_bits=0, kv_bits=0, max_new=5, n_slots=2,
            max_len=32, mode="paged", port_attn="gather", scfg_kw=None,
            **kw):
    cfg, jparams, _ = _jax_model(arch, 0)
    scfg_kw = scfg_kw or {}
    if pkg == "jax":
        ecfg = JaxEngineConfig(weight_bits=weight_bits, kv_bits=kv_bits,
                               backend="reference")
        return JaxServeEngine(
            cfg, jparams, JaxServeConfig(max_new_tokens=max_new, engine=ecfg,
                                         **scfg_kw),
            n_slots=n_slots, max_len=max_len, mode=mode,
            attn_backend="gather", **kw)
    tcfg, tparams, _ = _port_model(arch, 0)
    ecfg = tconfig.EngineConfig(weight_bits=weight_bits, kv_bits=kv_bits)
    return ServeEngine(
        tcfg, tparams, tconfig.ServeConfig(max_new_tokens=max_new,
                                           engine=ecfg, **scfg_kw),
        n_slots=n_slots, max_len=max_len, mode=mode, attn_backend=port_attn,
        device="cpu", **kw)


def _run(eng, prompts=PROMPTS):
    for p in prompts:
        eng.submit(list(p))
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert len(done) == len(prompts)
    assert all(r.done and len(r.output) == eng.scfg.max_new_tokens
               for r in done)
    return done


def _serve_both(arch, **kw):
    return [(eng, _run(eng)) for eng in
            (_engine("jax", arch, **kw), _engine("torch", arch, **kw))]


@pytest.mark.parametrize("weight_bits,kv_bits,attn_backend",
                         [(0, 0, "gather"), (0, 8, "gather"),
                          (4, 8, "gather"), (4, 8, "cuda")])
@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_paged_tokens_and_logits_match_jax(arch, weight_bits, kv_bits,
                                           attn_backend):
    """llava (text prompts) and musicgen (each id broadcast over the
    codebooks, ``(K, V)`` last logits, codebook 0 sampled) served paged,
    more requests than lanes, chunks shorter than some prompts: JAX's
    greedy tokens, final logits within 1e-4 (full-precision pages) or
    DENSE_KV8_TOL (int8 pages: one bf16 rounding of ``p * s_v`` falling
    the other way moves reduced llava's final logits by 1.8e-3 at float32
    weights and musicgen's by 1.9e-3 at 4-bit ones, on one request each;
    ``ROADMAP.md`` queue 3).
    ``cuda`` on the CPU runs the paged kernels' plain versions behind
    their wrappers."""
    (_, jreq), (teng, treq) = _serve_both(
        arch, weight_bits=weight_bits, kv_bits=kv_bits, page_size=4,
        prefill_chunk=3, port_attn=attn_backend)
    assert teng.mode == "paged" and teng.attn_backend == attn_backend
    tol = DENSE_KV8_TOL if kv_bits else TOL
    for j, t in zip(jreq, treq):
        assert j.output == t.output, (arch, j.rid, j.output, t.output)
        assert t.last_logits.shape == np.asarray(j.last_logits).shape
        np.testing.assert_allclose(t.last_logits, np.asarray(j.last_logits),
                                   **tol)
    if arch == "musicgen-medium":
        assert teng.lanes.tokens.shape == (2, 1, teng.cfg.n_codebooks)
        assert teng.lanes.chunk_tokens.shape == (2, 3, teng.cfg.n_codebooks)


def test_audio_paged_matches_slots():
    """musicgen's paged greedy tokens equal its slots-mode tokens in the
    port (JAX's ``test_paged_matches_slots`` for the audio family)."""
    paged = _run(_engine("torch", "musicgen-medium", page_size=4,
                         prefill_chunk=3))
    slots = _run(_engine("torch", "musicgen-medium", mode="slots"))
    assert [r.output for r in paged] == [r.output for r in slots]


SHARED = [list(range(1, 11)) + [40 + i, 50 + i] for i in range(3)]


def test_audio_prefix_cache_matches_jax():
    """musicgen with the prefix cache: the tree keys on the single id each
    codebook carries, so hits, hit tokens and forks equal JAX's and the
    tokens equal the cold run's."""
    kw = dict(n_slots=1, max_len=32, page_size=4, prefill_chunk=3,
              scfg_kw=dict(audit=2))
    jeng = _engine("jax", "musicgen-medium", prefix_cache=True, **kw)
    teng = _engine("torch", "musicgen-medium", prefix_cache=True, **kw)
    ceng = _engine("torch", "musicgen-medium", prefix_cache=False, **kw)
    jreq, treq, creq = (_run(e, SHARED) for e in (jeng, teng, ceng))
    for j, t, c in zip(jreq, treq, creq):
        assert t.output == j.output == c.output, t.rid
    assert teng.prefix_stats() == jeng.prefix_stats()
    assert teng.prefix_stats()["hits"] == len(SHARED) - 1
    assert teng.prefill_computed == jeng.sched.prefill_computed
    assert teng.prefill_computed < ceng.prefill_computed


def test_audio_budget_scheduler_matches_jax():
    """musicgen under ``sched="budget"`` (7 tokens a step): JAX's tokens
    and prefill work."""
    kw = dict(n_slots=3, max_len=32, page_size=4, prefill_chunk=4,
              scfg_kw=dict(sched="budget", step_tokens=7, audit=2))
    (jeng, jreq), (teng, treq) = [
        (e, _run(e)) for e in (_engine("jax", "musicgen-medium", **kw),
                               _engine("torch", "musicgen-medium", **kw))]
    for j, t in zip(jreq, treq):
        assert j.output == t.output, (j.rid, j.output, t.output)
    assert teng.prefill_computed == jeng.sched.prefill_computed


# ---------------------------------------------------- the hybrid family
@pytest.mark.parametrize("weight_bits", [0, 4])
def test_hybrid_slots_tokens_and_logits_match_jax(weight_bits):
    """zamba2 in slots mode, more requests than slots (a slot reused, its
    conv and h states reset, its sites' K/V overwritten): JAX's greedy
    tokens and final logits within 1e-4."""
    (_, jreq), (teng, treq) = _serve_both(
        "zamba2-7b", weight_bits=weight_bits, mode="slots", max_new=6)
    assert teng.mode == "slots"
    assert teng.cache["k"].shape[0] == teng.cfg.n_layers // (
        teng.cfg.attn_every)
    for j, t in zip(jreq, treq):
        assert j.output == t.output, (j.rid, j.output, t.output)
        np.testing.assert_allclose(t.last_logits, np.asarray(j.last_logits),
                                   **TOL)


def test_hybrid_auto_falls_back_to_slots_as_jax_does(caplog):
    with caplog.at_level(logging.WARNING):
        jeng = _engine("jax", "zamba2-7b", mode="auto")
        teng = _engine("torch", "zamba2-7b", mode="auto")
    assert teng.mode == jeng.mode == "slots"
    said = {name: [r.message for r in caplog.records if r.name == name]
            for name in ("repro.serve.engine", PORT_LOGGER)}
    assert said[PORT_LOGGER] == said["repro.serve.engine"]
    assert len(said[PORT_LOGGER]) == 1 and "'hybrid'" in said[PORT_LOGGER][0]


def test_hybrid_paged_is_refused_as_jax_refuses_it():
    with pytest.raises(ValueError) as jerr:
        _engine("jax", "zamba2-7b", mode="paged")
    with pytest.raises(ValueError) as terr:
        _engine("torch", "zamba2-7b", mode="paged")
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------- the cost ledger
def _table(c):
    return {op: (v.flops, v.bytes) for op, v in c.items()}


@pytest.mark.parametrize("weight_bits", [0, 4])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_audio_cost_tables_equal_jax(kind, weight_bits):
    """musicgen's decode step and prefill chunk priced op by op as JAX
    prices them: its ``V·K`` head from the live tree, ``model_dims`` with
    the per-codebook vocabulary."""
    cfg, jparams, _ = _jax_model("musicgen-medium", weight_bits)
    tcfg, tparams, _ = _port_model("musicgen-medium", weight_bits)
    jspecs = jcosts.linear_specs(jparams)
    tspecs = tcosts.linear_specs(tparams)
    assert [dataclasses.asdict(s) for s in tspecs] == [
        dataclasses.asdict(s) for s in jspecs]
    head = next(s for s in tspecs if s.name == "lm_head")
    assert head.out_features == tcfg.vocab_size * tcfg.n_codebooks
    assert (dataclasses.asdict(tcosts.model_dims(tcfg))
            == dataclasses.asdict(jcosts.model_dims(cfg)))
    kw = dict(batch=3, context=21, page_size=4, kv_bits=8,
              weight_bits=weight_bits)
    if kind == "prefill":
        kw["chunk"] = 5
        fn, jfn = tcosts.prefill_chunk_costs, jcosts.prefill_chunk_costs
    else:
        fn, jfn = tcosts.decode_step_costs, jcosts.decode_step_costs
    port = fn(tcosts.model_dims(tcfg), attn_backend="gather", specs=tspecs,
              **kw)
    ref = jfn(jcosts.model_dims(cfg), attn_backend="gather", specs=jspecs,
              **kw)
    assert _table(port) == _table(ref)


def test_hybrid_shared_block_priced_once_as_jax_prices_it():
    """zamba2's ``shared_attn`` linears are one spec each with ``stack``
    1 in both packages' walks, although a step applies the block at every
    site (``ROADMAP.md`` reference caveat (g))."""
    cfg, jparams, _ = _jax_model("zamba2-7b", 4)
    _, tparams, _ = _port_model("zamba2-7b", 4)
    tspecs = tcosts.linear_specs(tparams)
    assert [dataclasses.asdict(s) for s in tspecs] == [
        dataclasses.asdict(s) for s in jcosts.linear_specs(jparams)]
    shared = [s for s in tspecs if s.name.startswith("shared_attn/")]
    assert len(shared) == 7 and all(s.stack == 1 for s in shared)
