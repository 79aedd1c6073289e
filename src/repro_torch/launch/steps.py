"""Per-cell step builders: the JAX package's ``repro/launch/steps.py``.

  train_4k               -> train_cell          (FSDP forward + backward +
                                                 AdamW, ``make_train_step``)
  prefill_32k            -> prefill_cell        (one-shot ``prefill``) or
                            chunked_prefill_cell (one ``prefill_chunk``)
  decode_32k / long_500k -> serve_cell          (one ``decode_step``) or
                            paged_serve_cell    (one ``decode_step_paged``)

Each returns ``(fn, args)``: ``fn(*args)`` runs one step of the cell on
one rank of ``mesh`` (a ``dist.hints.Mesh``: a dry mesh for the dry run,
a real one, or ``launch.mesh.make_host_mesh()``'s ``(1, 1)`` on one
card).  ``args`` are the rank's shards: with ``abstract=True`` empty
``meta`` tensors (the counterpart of JAX's ``ShapeDtypeStruct`` s with
shardings: no memory is taken), with ``abstract=False`` real tensors on
``device`` from a seeded ``torch.Generator`` (weights as ``init_params``
draws them; tokens uniform; paged and slots caches full to the cell's
``seq_len``, so a step reads every key the count prices).

Placement: the serving cells place the params by ``dist.sharding.
serve_param_specs`` (whole heads, experts over ``model``, SSM blocks
whole), the caches and index state at the rank's lanes and KV heads; the
train cell stores params and optimizer state by FSDP
(``train.trainer.mesh_specs(mode="fsdp")``) and takes the global batch.
Names the config leaves at ``"auto"`` resolve as on the card (``cuda``)
on ``meta``, so a dry run prices the program the card runs.  With packed
weights on more than one model rank the engine runs its ``sharded``
backend, as the port's mesh needs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import synthetic_batch_specs
from repro_torch.device import DeviceLike
from repro_torch.dist.sharding import (
    batch_shardings,
    local_shard,
    meta_params,
    pool_pages_for_mesh,
    serve_param_specs,
)
from repro_torch.engine import resolve_plan
from repro_torch.engine.backends import resolve_attn_backend
from repro_torch.models import init_params
from repro_torch.models.transformer import (
    decode_step,
    decode_step_paged,
    init_cache,
    prefill,
    prefill_chunk,
    rank_view,
)
from repro_torch.optim import ef_state_init, make_optimizer
from repro_torch.serve.pages import init_kv_pages, pages_for
from repro_torch.train.trainer import make_train_step, mesh_specs
from repro_torch.weights import stack_layers

Pytree = Any
Cell = Tuple[Callable, Tuple]


def abstract_params(cfg: ModelConfig, engine_bits: int = 0) -> Pytree:
    """The whole param tree of ``cfg`` (``engine_bits`` packed) as empty
    ``meta`` tensors (``dist.sharding.meta_params``): JAX's
    ``jax.eval_shape`` of ``init_params``."""
    return meta_params(cfg, engine_bits)


def sharded_abstract_params(cfg: ModelConfig, mesh,
                            engine_bits: int = 0) -> Pytree:
    """The rank's shards of :func:`abstract_params` under the serving
    placement."""
    ap = abstract_params(cfg, engine_bits)
    return local_shard(ap, serve_param_specs(mesh, ap, cfg), mesh)


def _device(abstract: bool, device: DeviceLike) -> torch.device:
    if abstract:
        return torch.device("meta")
    if device is None:
        raise ValueError("abstract=False needs a device")
    return torch.device(device)


def _route_device(device: torch.device) -> torch.device:
    """The device ``"auto"`` names resolve for: the card on ``meta``."""
    return torch.device("cuda") if device.type == "meta" else device


def _params(cfg, mesh, bits, device, seed) -> Pytree:
    if device.type == "meta":
        return sharded_abstract_params(cfg, mesh, bits)
    gen = torch.Generator(device).manual_seed(seed)
    tree = init_params(cfg, gen, engine_bits=bits)
    return local_shard(tree, serve_param_specs(mesh, tree, cfg), mesh)


def _plan(run: RunConfig, mesh, device):
    eng = run.serve.engine
    if (eng is not None and eng.enabled and not eng.sharded
            and mesh.count("model") > 1):
        eng = dataclasses.replace(eng, sharded=True)
    plan = resolve_plan(eng, device=_route_device(device), mesh=mesh)
    abk = (plan.attn_backend if plan else resolve_attn_backend(
        getattr(eng, "attn_backend", None), _route_device(device)))
    return plan, abk


def _local_rows(rows: int, mesh) -> int:
    spec = batch_shardings(mesh, {"x": torch.empty((rows,),
                                                   device="meta")})["x"]
    return rows // (mesh.count(spec[0]) if spec[0] is not None else 1)


def _ints(shape, high: int, device, gen) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.int32, device=device)
    return torch.randint(0, high, shape, generator=gen, device=device,
                         dtype=torch.int32)


def _batch(cfg, rows, seq, device, gen, labels: bool) -> Dict[str, Any]:
    specs = synthetic_batch_specs(cfg, rows, seq, device=device)
    if device.type != "meta":
        for k in ("tokens", "labels"):
            specs[k] = _ints(specs[k].shape, cfg.vocab_size, device, gen)
        if "img_embeds" in specs:
            specs["img_embeds"] = torch.randn(
                specs["img_embeds"].shape, generator=gen, device=device)
    if not labels:
        specs.pop("labels")
    return specs


def _text_seq(cfg, seq: int) -> int:
    return seq - cfg.img_tokens if cfg.family == "vlm" else seq


def _gen(device, seed):
    return (None if device.type == "meta"
            else torch.Generator(device).manual_seed(seed + 1))


def train_cell(run: RunConfig, mesh, *, abstract: bool = True,
               device: DeviceLike = None, seed: int = 0) -> Cell:
    """One FSDP train step: ``(fn, (params, opt_state, ef_state,
    batch))``, the state the rank's FSDP shards in the stacked layout,
    the batch global (the step takes its data shard)."""
    cfg, shape, tcfg = run.model, run.shape, run.train
    device = _device(abstract, device)
    specs = mesh_specs(cfg, tcfg, mesh, mode="fsdp")
    if device.type == "meta":
        whole = stack_layers(abstract_params(cfg))
    else:
        whole = stack_layers(init_params(
            cfg, torch.Generator(device).manual_seed(seed)))
    params = local_shard(whole, specs["params"], mesh)
    del whole
    init_fn, _ = make_optimizer(tcfg.optimizer)
    opt = init_fn(params)
    ef = ef_state_init(params) if tcfg.grad_compress_bits else {}
    batch = _batch(cfg, shape.global_batch, _text_seq(cfg, shape.seq_len),
                   device, _gen(device, seed), labels=True)
    fn = make_train_step(cfg, tcfg, donate=True, mesh=mesh, mode="fsdp")
    return fn, (params, opt, ef, batch)


def prefill_cell(run: RunConfig, mesh, *, abstract: bool = True,
                 device: DeviceLike = None, seed: int = 0) -> Cell:
    """One-shot ``prefill`` of the rank's rows: ``(fn, (params, batch,
    cache))``; the cache is written in place."""
    cfg, shape = run.model, run.shape
    device = _device(abstract, device)
    plan, abk = _plan(run, mesh, device)
    params = _params(cfg, mesh, plan.bits if plan else 0, device, seed)
    rows = _local_rows(shape.global_batch, mesh)
    seq = shape.seq_len
    batch = _batch(cfg, rows, _text_seq(cfg, seq), device,
                   _gen(device, seed), labels=False)
    cache = init_cache(cfg, rows, seq, device=device,
                       n_kv_heads=rank_view(params, cfg, mesh).hkv)

    def fn(params, batch, cache):
        return prefill(params, batch, cfg, cache, plan, attn_backend=abk,
                       mesh=mesh)

    return fn, (params, batch, cache)


def _pool(run, mesh, params, plan, device):
    """``(pages, block_tables, rows, n_blocks)``: the rank's page pool at
    full capacity for the cell's lanes, each lane owning ``n_blocks``
    pages of its own (page 0 the null page)."""
    cfg, shape = run.model, run.shape
    b = shape.global_batch
    page_size = run.serve.page_size
    n_blocks = pages_for(shape.seq_len, page_size)
    n_pages = pool_pages_for_mesh(run.serve.n_pages or b * n_blocks + 1,
                                  mesh)
    local_pages = n_pages // mesh.count(mesh.data_axes())
    rows = _local_rows(b, mesh)
    pages = init_kv_pages(cfg, local_pages, page_size,
                          kv_bits=plan.kv_bits if plan else 0,
                          device=device,
                          n_kv_heads=rank_view(params, cfg, mesh).hkv)
    if device.type == "meta":
        bt = torch.empty((rows, n_blocks), dtype=torch.int32, device=device)
    else:
        bt = (1 + torch.arange(rows * n_blocks, device=device,
                               dtype=torch.int32)).reshape(rows, n_blocks)
    return pages, bt, rows, n_blocks


def _lane_ints(rows, value, device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty((rows,), dtype=torch.int32, device=device)
    return torch.full((rows,), value, dtype=torch.int32, device=device)


def chunked_prefill_cell(run: RunConfig, mesh, *, abstract: bool = True,
                         device: DeviceLike = None, seed: int = 0) -> Cell:
    """One batched chunk of prompt prefill against the paged pool, what
    the paged schedulers run per engine step: ``(fn, (params, pages,
    block_tables, tokens, pos0, seq_lens))``.  With real tensors every
    lane prefills the last chunk of a full-length prompt."""
    cfg = run.model
    device = _device(abstract, device)
    plan, abk = _plan(run, mesh, device)
    params = _params(cfg, mesh, plan.bits if plan else 0, device, seed)
    pages, bt, rows, n_blocks = _pool(run, mesh, params, plan, device)
    chunk = run.serve.prefill_chunk
    tok = ((rows, chunk, cfg.n_codebooks) if cfg.family == "audio"
           else (rows, chunk))
    tokens = _ints(tok, cfg.vocab_size, device, _gen(device, seed))
    end = min(run.shape.seq_len, n_blocks * run.serve.page_size)
    pos0 = _lane_ints(rows, max(0, end - chunk), device)
    seq_lens = _lane_ints(rows, end, device)

    def fn(params, pages, bt, tokens, pos0, seq_lens):
        return prefill_chunk(params, pages, bt, tokens, pos0, seq_lens, cfg,
                             plan, attn_backend=abk, mesh=mesh)

    return fn, (params, pages, bt, tokens, pos0, seq_lens)


def paged_serve_cell(run: RunConfig, mesh, *, abstract: bool = True,
                     device: DeviceLike = None, seed: int = 0) -> Cell:
    """One decode token a lane against the paged pool at full capacity:
    ``(fn, (params, pages, block_tables, pos, active, tokens))``.  With
    real tensors every lane decodes at position ``seq_len - 1``."""
    cfg = run.model
    device = _device(abstract, device)
    plan, abk = _plan(run, mesh, device)
    params = _params(cfg, mesh, plan.bits if plan else 0, device, seed)
    pages, bt, rows, _ = _pool(run, mesh, params, plan, device)
    pos = _lane_ints(rows, run.shape.seq_len - 1, device)
    if device.type == "meta":
        active = torch.empty((rows,), dtype=torch.bool, device=device)
    else:
        active = torch.ones((rows,), dtype=torch.bool, device=device)
    tok = ((rows, 1, cfg.n_codebooks) if cfg.family == "audio"
           else (rows, 1))
    tokens = _ints(tok, cfg.vocab_size, device, _gen(device, seed))

    def fn(params, pages, bt, pos, active, tokens):
        return decode_step_paged(params, pages, bt, pos, active, tokens,
                                 cfg, plan, attn_backend=abk, mesh=mesh)

    return fn, (params, pages, bt, pos, active, tokens)


def serve_cell(run: RunConfig, mesh, split_local: bool = False,
               stacked: bool = False, paged: bool = False, *,
               abstract: bool = True, device: DeviceLike = None,
               seed: int = 0) -> Cell:
    """One decode token a lane over the slots cache (unstacked by default,
    JAX's production decode layout): ``(fn, (params, cache, tokens))``;
    ``paged=True`` is :func:`paged_serve_cell`.  With real tensors every
    lane decodes at position ``seq_len - 1``."""
    if paged:
        return paged_serve_cell(run, mesh, abstract=abstract, device=device,
                                seed=seed)
    cfg, shape = run.model, run.shape
    device = _device(abstract, device)
    plan, _ = _plan(run, mesh, device)
    params = _params(cfg, mesh, plan.bits if plan else 0, device, seed)
    rows = _local_rows(shape.global_batch, mesh)
    cache = init_cache(cfg, rows, shape.seq_len, split_local=split_local,
                       stacked=stacked, kv_bits=plan.kv_bits if plan else 0,
                       device=device,
                       n_kv_heads=rank_view(params, cfg, mesh).hkv)
    if device.type != "meta":
        cache["pos"].fill_(shape.seq_len - 1)
    tok = ((rows, 1, cfg.n_codebooks) if cfg.family == "audio"
           else (rows, 1))
    tokens = _ints(tok, cfg.vocab_size, device, _gen(device, seed))

    def fn(params, cache, tokens):
        return decode_step(params, cache, tokens, cfg, plan, mesh=mesh)

    return fn, (params, cache, tokens)


def build_cell(run: RunConfig, mesh, *, abstract: bool = True,
               device: DeviceLike = None, seed: int = 0,
               **kw) -> Tuple[Callable, Tuple, str]:
    """``(fn, args, kind)`` for the run's shape cell (``kw``: ``chunked``
    for a prefill cell; ``split_local`` / ``stacked`` / ``paged`` for a
    decode cell)."""
    kind = run.shape.kind
    where = dict(abstract=abstract, device=device, seed=seed)
    if kind == "train":
        fn, args = train_cell(run, mesh, **where)
    elif kind == "prefill":
        if kw.pop("chunked", False):
            fn, args = chunked_prefill_cell(run, mesh, **where)
        else:
            fn, args = prefill_cell(run, mesh, **where)
    elif kind == "decode":
        fn, args = serve_cell(run, mesh, **kw, **where)
    else:
        raise ValueError(kind)
    return fn, args, kind


def cache_bytes(run: RunConfig, kind: str, *, paged: bool = False,
                chunked: bool = False, split_local: bool = False,
                stacked: bool = False) -> float:
    """Bytes of the whole cell's cache (every rank's together; ``pos``
    left out), the ``cache_bytes`` of JAX's ``model_bytes_for_cell``."""
    cfg, shape = run.model, run.shape
    eng = run.serve.engine
    kv_bits = eng.kv_bits if eng is not None else 0
    meta = torch.device("meta")
    if kind not in ("decode", "prefill"):
        return 0.0
    if (kind == "decode" and paged) or (kind == "prefill" and chunked):
        b = shape.global_batch
        n_blocks = pages_for(shape.seq_len, run.serve.page_size)
        pages = init_kv_pages(cfg, run.serve.n_pages or b * n_blocks + 1,
                              run.serve.page_size, kv_bits=kv_bits,
                              device=meta)
        leaves = [t for t in (pages.k, pages.v, pages.k_scale,
                              pages.v_scale) if t is not None]
    else:
        decode = kind == "decode"
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           split_local=split_local and decode,
                           stacked=stacked or not decode,
                           kv_bits=kv_bits if decode else 0, device=meta)
        leaves = []
        for name, v in cache.items():
            if name != "pos":
                leaves.extend(v if isinstance(v, tuple) else [v])
    return float(sum(t.numel() * t.element_size() for t in leaves))
