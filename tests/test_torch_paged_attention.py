"""PyTorch port vs JAX: paged decode and chunked-prefill attention.

The same pools, block tables, queries and positions (numpy, from a seed) go
through the JAX package's ``paged_attention_ref`` / ``paged_prefill_ref``,
its ``gather`` read path (``attend_paged_decode`` / ``attend_paged_prefill``)
and its Pallas kernels in interpret mode, and through the port's plain
versions (``kernels/paged_attention/ref.py`` via the ``ops`` wrappers on CPU
tensors) and its ``gather`` path.  Cases: ragged last blocks, reshuffled
block tables, a sliding window, mid-page ``pos0``, a ragged last lane, and
float32 / bfloat16 / int8 pools.

Tolerances:
* float32 pools: rtol = atol = 1e-5 (float32 sums in another order);
* int8 pools: rtol = atol = 2e-3.  Both packages round ``p * s_v`` to
  bf16 after a float32 softmax, and JAX's (XLA's) ``exp`` and PyTorch's
  differ in the last bit for about one element in ten, so a bf16 rounding
  can fall the other way: one bf16 ulp (2^-8 relative) of one probability;
* bfloat16 pools: one bf16 ulp of the output.

The CUDA kernels have no CPU mode: their cases against the plain versions
are in ``tests/test_torch_cuda_kernels.py``.  The chunked prefill's
tensor-core route (``kernel.prefill_route``: bf16 queries over bf16 or int8
pools) is modelled here in plain torch (``_tc_prefill_model``: its blocks
of 64 query rows, 64-key steps of the page walk, the TPU kernel's bf16
casts on exact bf16 values, float32 sums) and held against JAX's gather
oracle and its Pallas kernel in interpret mode at ``chip_smoke.py``'s
tolerance for bf16 / int8 pools (``attn_tol``: rtol = atol = 2^-7).  The
decode kernel's split-KV arithmetic is modelled the same way
(``_split_kv_model``: per split of ``kernel.decode_split_tokens`` keys the
TPU kernel's casts, (m, l, acc) in float32, then the ordered combine) and
held against ``paged_attention_ref`` and the Pallas kernel in interpret
mode at the decode tolerances above (bf16 pools at ``attn_tol``), with
contexts that leave splits empty
(past ``cur_pos``, or before the window).  Head dims outside the prefill
tiles' 32 / 64 / 128 go through the launcher's zero padding
(``kernels/_heads.py``) into the same model, against JAX.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import (
    paged_attention_pallas as jax_decode_pallas,
)
from repro.kernels.paged_attention.ops import synthetic_prefill_case
from repro.kernels.paged_attention.ref import (
    paged_attention_ref as jax_decode_ref,
    paged_prefill_ref as jax_prefill_ref,
)
from repro.models.attention import (
    attend_paged_decode as jax_attend_decode,
    attend_paged_prefill as jax_attend_prefill,
)

from repro_torch.kernels import _build
from repro_torch.kernels._heads import pad_head_dim, padded_head_dim
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention.ref import gather_pages
from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_prefill_attention,
)
from repro_torch.models.attention import (
    attend_paged_decode,
    attend_paged_prefill,
)

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=2e-3, atol=2e-3)
TC_TOL = dict(rtol=2 ** -7, atol=2 ** -7)   # chip_smoke.py's attn_tol


def _t(a):
    """A JAX or numpy array as a torch tensor (bf16 stays bf16, exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _pool(rng, n_pages, page, hkv, dh, kv_bits):
    if kv_bits:
        kp = rng.integers(-127, 128, (n_pages, page, hkv, dh)).astype(np.int8)
        vp = rng.integers(-127, 128, (n_pages, page, hkv, dh)).astype(np.int8)
        ks = jnp.asarray(rng.uniform(0.004, 0.02, (n_pages, page, hkv)),
                         jnp.bfloat16)
        vs = jnp.asarray(rng.uniform(0.004, 0.02, (n_pages, page, hkv)),
                         jnp.bfloat16)
        return kp, vp, np.asarray(ks), np.asarray(vs)
    kp = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, dh)).astype(np.float32)
    return kp, vp, None, None


def _jx(a):
    return None if a is None else jnp.asarray(a)


def _tx(a):
    return None if a is None else _t(a)


# ------------------------------------------------------------------ decode
def _decode_case(page, group, kv_bits, seed=7):
    rng = np.random.default_rng(seed)
    b, hkv, dh, nblk = 3, 2, 8, 4
    n_pages = b * nblk + 1
    kp, vp, ks, vs = _pool(rng, n_pages, page, hkv, dh, kv_bits)
    bt = (1 + rng.permutation(b * nblk).reshape(b, nblk)).astype(np.int32)
    q = rng.standard_normal((b, 1, hkv * group, dh)).astype(np.float32)
    # no lane on a page boundary; lane 2 has a nearly empty last block
    pos = np.asarray([page * nblk - 2, page + 1, 0], np.int32)
    return q, kp, vp, bt, pos, ks, vs


@pytest.mark.parametrize(
    "page,group,window,kv_bits",
    [(p, g, w, kb) for p, g in itertools.product((2, 4), (1, 3))
     for w, kb in ((0, 0), (5, 0), (0, 8), (5, 8))])
def test_decode_matches_jax(page, group, window, kv_bits):
    q, kp, vp, bt, pos, ks, vs = _decode_case(page, group, kv_bits)
    tol = INT8_TOL if kv_bits else F32_TOL
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
             jnp.asarray(bt), jnp.asarray(pos), window)
    targs = (_t(q), _t(kp), _t(vp), _t(bt), _t(pos), window)
    want_ref = np.asarray(jax_decode_ref(*jargs, _jx(ks), _jx(vs)))
    got_ref = paged_attention(*targs, _tx(ks), _tx(vs))
    assert got_ref.shape == q.shape and got_ref.dtype == torch.float32
    np.testing.assert_allclose(got_ref.numpy(), want_ref, **tol)

    want_gather = np.asarray(jax_attend_decode(
        *jargs, k_scale=_jx(ks), v_scale=_jx(vs), attn_backend="gather"))
    got_gather = attend_paged_decode(*targs, k_scale=_tx(ks), v_scale=_tx(vs),
                                     attn_backend="gather")
    np.testing.assert_allclose(got_gather.numpy(), want_gather, **tol)

    want_pallas = np.asarray(jax_attend_decode(
        *jargs, k_scale=_jx(ks), v_scale=_jx(vs),
        attn_backend="pallas_interpret"))
    np.testing.assert_allclose(got_ref.numpy(), want_pallas,
                               **(dict(rtol=1e-2, atol=1e-2) if kv_bits
                                  else F32_TOL))


def test_decode_invariant_under_page_reshuffle():
    """A resumed request gets other physical pages: the same logical
    content through a permuted block table gives bit-identical output."""
    q, kp, vp, bt, pos, _, _ = _decode_case(4, 2, 0, seed=11)
    rng = np.random.default_rng(12)
    perm = np.concatenate([[0], 1 + rng.permutation(kp.shape[0] - 1)])
    inv = np.argsort(perm)
    out1 = paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    out2 = paged_attention(_t(q), _t(kp[perm]), _t(vp[perm]),
                           _t(inv[bt].astype(np.int32)), _t(pos))
    assert torch.equal(out1, out2)


def test_decode_bf16_pools_match_jax():
    """bf16 pools and queries, the served model's dtype: q and p are
    rounded to the pool dtype as in JAX; one bf16 ulp of the output."""
    q, kp, vp, bt, pos, _, _ = _decode_case(4, 2, 0, seed=5)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kp, vp))
    want = np.asarray(jax_decode_ref(qb, kb, vb, jnp.asarray(bt),
                                     jnp.asarray(pos), 0)).astype(np.float32)
    got = paged_attention(_t(qb), _t(kb), _t(vb), _t(bt), _t(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -9)


# ----------------------------------------------------------------- prefill
def _prefill_case(seed, **kw):
    case = synthetic_prefill_case(np.random.default_rng(seed), **kw)
    return {k: (None if v is None else np.asarray(v)) for k, v in case.items()}


def _prefill_both(case, window):
    """(JAX ref, JAX gather, JAX interpret, port ref, port gather)."""
    b, c = case["q"].shape[:2]
    positions = case["pos0"][:, None] + np.arange(c, dtype=np.int32)[None]
    names = ("q", "k_pages", "v_pages", "block_tables")
    jx = [jnp.asarray(case[n]) for n in names]
    tx = [_t(case[n]) for n in names]
    jks, jvs = _jx(case["k_scale"]), _jx(case["v_scale"])
    tks, tvs = _tx(case["k_scale"]), _tx(case["v_scale"])
    jpos0, jseq = jnp.asarray(case["pos0"]), jnp.asarray(case["seq_lens"])
    tpos0, tseq = _t(case["pos0"]), _t(case["seq_lens"])
    out = [jax_prefill_ref(*jx, jpos0, jseq, window, jks, jvs)]
    for abk in ("gather", "pallas_interpret"):
        out.append(jax_attend_prefill(*jx, jnp.asarray(positions), jpos0,
                                      jseq, window, k_scale=jks, v_scale=jvs,
                                      attn_backend=abk))
    out = [np.asarray(o) for o in out]
    out.append(paged_prefill_attention(*tx, tpos0, tseq, window, tks,
                                       tvs).numpy())
    out.append(attend_paged_prefill(*tx, _t(positions), tpos0, tseq, window,
                                    k_scale=tks, v_scale=tvs,
                                    attn_backend="gather").numpy())
    return out


@pytest.mark.parametrize("window,kv_bits", [(0, 0), (6, 0), (0, 8), (6, 8)])
def test_prefill_matches_jax(window, kv_bits):
    """Every lane's ``pos0`` lands mid-page and the last lane's chunk is
    ragged (``seq_lens < pos0 + chunk``)."""
    case = _prefill_case(17, batch=3, nblk=5, page=4, hkv=2, group=2, dh=16,
                         chunk=6, kv_bits=kv_bits)
    j_ref, j_gather, j_pallas, t_ref, t_gather = _prefill_both(case, window)
    tol = INT8_TOL if kv_bits else F32_TOL
    np.testing.assert_allclose(t_ref, j_ref, **tol)
    np.testing.assert_allclose(t_gather, j_gather, **tol)
    np.testing.assert_allclose(t_ref, j_pallas,
                               **(dict(rtol=1e-2, atol=1e-2) if kv_bits
                                  else F32_TOL))


def test_prefill_ragged_last_page():
    """One valid token on the last page: the ``kv_pos < limit`` mask drops
    exactly the unwritten tail."""
    case = _prefill_case(23, batch=1, nblk=4, page=4, hkv=2, group=1, dh=8,
                         chunk=9, kv_bits=0)
    case["pos0"] = np.zeros_like(case["pos0"])
    case["seq_lens"] = np.full_like(case["seq_lens"], 9)
    j_ref, j_gather, j_pallas, t_ref, t_gather = _prefill_both(case, 0)
    for want in (j_ref, j_gather, j_pallas):
        np.testing.assert_allclose(t_ref, want, **F32_TOL)
    np.testing.assert_allclose(t_gather, j_gather, **F32_TOL)


def test_prefill_midpage_pos0():
    """Suffix prefill after a match that ends inside a page."""
    case = _prefill_case(29, batch=2, nblk=5, page=4, hkv=2, group=2, dh=8,
                         chunk=5, kv_bits=0)
    case["pos0"] = np.asarray([4 + 2, 8 + 3], np.int32)
    case["seq_lens"] = case["pos0"] + 5
    j_ref, j_gather, j_pallas, t_ref, t_gather = _prefill_both(case, 0)
    for want in (j_ref, j_gather, j_pallas):
        np.testing.assert_allclose(t_ref, want, **F32_TOL)
    np.testing.assert_allclose(t_gather, j_gather, **F32_TOL)


def test_cuda_launchers_refuse_cpu_tensors():
    q, kp, vp, bt, pos, _, _ = _decode_case(4, 2, 0)
    b, _, hq, dh = q.shape
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="not on the query's CUDA device"):
        pa_kernel.paged_decode_attention_cuda(
            _t(q).reshape(b, 2, hq // 2, dh), _t(kp), _t(vp), _t(bt),
            _t(pos))
    with pytest.raises(ValueError, match="not on the query's CUDA device"):
        pa_kernel.paged_prefill_attention_cuda(
            _t(q).reshape(b, 1, 2, hq // 2, dh), _t(kp), _t(vp), _t(bt),
            _t(pos), _t(pos + 1))
    assert _build.LAUNCHES == before


# ------------------------------------- the prefill's tensor-core route
@pytest.mark.parametrize("q_dtype,pool_dtype,want", [
    (torch.bfloat16, torch.bfloat16, "tensor_core"),
    (torch.bfloat16, torch.int8, "tensor_core"),
    (torch.float32, torch.bfloat16, "cuda_core"),
    (torch.float32, torch.int8, "cuda_core"),
    (torch.bfloat16, torch.float32, "cuda_core"),
    (torch.float32, torch.float32, "cuda_core")])
@pytest.mark.parametrize("dh", pa_kernel.TC_HEAD_DIMS)
def test_prefill_route_by_dtype(q_dtype, pool_dtype, want, dh):
    assert pa_kernel.prefill_route(q_dtype, pool_dtype, dh, 8) == want


@pytest.mark.parametrize("q_dtype,pool_dtype,dh,group", [
    (torch.bfloat16, torch.bfloat16, 288, 8),    # head dim past the tiles
    (torch.bfloat16, torch.int8, 128, 65),       # rows a block
    (torch.float16, torch.bfloat16, 128, 8),     # dtypes
    (torch.bfloat16, torch.float16, 128, 8)])
def test_prefill_route_refuses_what_no_design_takes(q_dtype, pool_dtype, dh,
                                                    group):
    """Other dtypes and more query heads a KV head than a tile's rows are
    refused; a head dim past the tiles is no longer: the CUDA-core design
    takes it as it is."""
    if dh > padded_head_dim(256, "t"):
        assert pa_kernel.prefill_route(q_dtype, pool_dtype, dh,
                                       group) == "cuda_core"
        return
    with pytest.raises(ValueError):
        pa_kernel.prefill_route(q_dtype, pool_dtype, dh, group)


@pytest.mark.parametrize("dh", [16, 96, 112])
@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.int8])
def test_prefill_route_pads_other_head_dims(pool_dtype, dh):
    """Head dims up to 128 outside the tiles' widths take the tensor-core
    route, zero-padded to the next width."""
    assert pa_kernel.prefill_route(torch.bfloat16, pool_dtype, dh,
                                   8) == "tensor_core"
    assert padded_head_dim(dh, "t") == {16: 32, 96: 128, 112: 128}[dh]


@pytest.mark.parametrize("dh", [160, 192, 256])
@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.int8])
def test_prefill_route_takes_head_dims_up_to_256(pool_dtype, dh):
    """Head dims in (128, 256] take the tensor-core route, padded to 256."""
    assert pa_kernel.prefill_route(torch.bfloat16, pool_dtype, dh,
                                   8) == "tensor_core"
    assert padded_head_dim(dh, "t") == 256


def _tc_prefill_model(q, kp, vp, bt, pos0, seq, window, ks=None, vs=None,
                      sm_scale=None):
    """The tensor-core route's arithmetic in plain torch; q ``(B, C, Hq,
    Dh)`` bf16, pools bf16 or int8 (with bf16 scales) -> ``(B, C, Hq, Dh)``
    bf16.  Per (lane, KV head, block of min(C, 64 // G) chunk offsets x G
    heads): 64-key steps over the keys some row of the block attends, from
    a page boundary; scores of exact bf16 products summed in float32, times
    ``sm_scale`` (D^-0.5 by default), times the K scale; l sums the float32
    p; p times the V scale, rounded to bf16, into p . v."""
    b, c, hq, dh = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    g = hq // hkv
    block_q = max(1, min(c, 64 // g))
    qf = q.float().reshape(b, c, hkv, g, dh)
    kg, vg = gather_pages(kp, bt).float(), gather_pages(vp, bt).float()
    quant = ks is not None
    if quant:
        ksg = gather_pages(ks, bt).float()
        vsg = gather_pages(vs, bt).float()
    neg = torch.tensor(-1e30)
    out = torch.zeros((b, c, hkv, g, dh))
    for lane in range(b):
        base, lim = int(pos0[lane]), min(int(seq[lane]), int(pos0[lane]) + c)
        for h in range(hkv):
            for c_lo in range(0, c, block_q):
                c_hi = min(c_lo + block_q, c) - 1
                rows = qf[lane, c_lo:c_hi + 1, h].reshape(-1, dh)
                qpos = base + c_lo + torch.arange(rows.shape[0]) // g
                kv_end = min(base + c_hi + 1, lim, kg.shape[1])
                kv_lo = (max(0, base + c_lo - window + 1) // page * page
                         if window > 0 else 0)
                m = torch.full((rows.shape[0],), -1e30)
                l = torch.zeros(rows.shape[0])
                o = torch.zeros((rows.shape[0], dh))
                for kv0 in range(kv_lo, kv_end, 64):
                    cols = torch.arange(kv0, min(kv0 + 64, kv_end))
                    sc = (rows @ kg[lane, cols, h].T) * (
                        dh ** -0.5 if sm_scale is None else sm_scale)
                    if quant:
                        sc = sc * ksg[lane, cols, h]
                    mask = (cols[None] <= qpos[:, None]) & (cols[None] < lim)
                    if window > 0:
                        mask = mask & (cols[None] > qpos[:, None] - window)
                    sc = torch.where(mask, sc, neg)
                    m_new = torch.maximum(m, sc.amax(-1))
                    corr = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    l = l * corr + p.sum(-1)
                    m = m_new
                    if quant:
                        p = p * vsg[lane, cols, h]
                    p = p.bfloat16().float()
                    o = o * corr[:, None] + p @ vg[lane, cols, h]
                out[lane, c_lo:c_hi + 1, h] = (
                    o / torch.clamp_min(l, 1e-30)[:, None]).reshape(-1, g,
                                                                    dh)
    return out.reshape(b, c, hq, dh).to(q.dtype)


@pytest.mark.parametrize("window", [0, 21])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("pools", ["bfloat16", "int8"])
def test_tensor_core_prefill_model_matches_jax(pools, group, window):
    """Contexts of up to 159 tokens (three 64-key steps), mid-page pos0, a
    ragged last lane; G = 1 (a block of 16 rows) and 4 (64 rows)."""
    case = _prefill_case(41 + group + window, batch=3, nblk=10, page=16,
                         hkv=2, group=group, dh=32, chunk=16,
                         kv_bits=8 if pools == "int8" else 0)
    q = torch.from_numpy(np.array(case["q"])).bfloat16()
    if pools == "int8":
        kp, vp = _t(case["k_pages"]), _t(case["v_pages"])
        ks, vs = _t(case["k_scale"]), _t(case["v_scale"])
    else:
        kp, vp = (torch.from_numpy(case[n]).bfloat16()
                  for n in ("k_pages", "v_pages"))
        ks = vs = None
    bt, pos0, seq = (_t(case[n]) for n in ("block_tables", "pos0",
                                           "seq_lens"))
    assert pa_kernel.prefill_route(q.dtype, kp.dtype, 32,
                                   group) == "tensor_core"
    got = _tc_prefill_model(q, kp, vp, bt, pos0, seq, window, ks, vs)
    assert got.dtype == torch.bfloat16

    def jx(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    jargs = [jx(t) for t in (q, kp, vp, bt)]
    jpos0, jseq = jx(pos0), jx(seq)
    positions = jpos0[:, None] + jnp.arange(q.shape[1], dtype=jnp.int32)
    wants = [jax_prefill_ref(*jargs, jpos0, jseq, window, jx(ks), jx(vs)),
             jax_attend_prefill(*jargs, positions, jpos0, jseq, window,
                                k_scale=jx(ks), v_scale=jx(vs),
                                attn_backend="pallas_interpret")]
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   **TC_TOL)


@pytest.mark.parametrize("window", [0, 21])
@pytest.mark.parametrize("dh", [16, 112, 192])
@pytest.mark.parametrize("pools", ["bfloat16", "int8"])
def test_tensor_core_prefill_pads_head_dim(pools, dh, window):
    """D = 16, 112 and 192 through the launcher's padding: q and both pools
    zero-padded to the tiles' width, the scale of the true D, the output
    sliced back; against JAX's gather oracle and its Pallas kernel."""
    case = _prefill_case(61 + dh + window, batch=3, nblk=6, page=16,
                         hkv=2, group=4, dh=dh, chunk=16,
                         kv_bits=8 if pools == "int8" else 0)
    q = torch.from_numpy(np.array(case["q"])).bfloat16()
    if pools == "int8":
        kp, vp = _t(case["k_pages"]), _t(case["v_pages"])
        ks, vs = _t(case["k_scale"]), _t(case["v_scale"])
    else:
        kp, vp = (torch.from_numpy(case[n]).bfloat16()
                  for n in ("k_pages", "v_pages"))
        ks = vs = None
    bt, pos0, seq = (_t(case[n]) for n in ("block_tables", "pos0",
                                           "seq_lens"))
    assert pa_kernel.prefill_route(q.dtype, kp.dtype, dh, 4) == "tensor_core"
    dp = padded_head_dim(dh, "paged_prefill_attention_cuda")
    got = _tc_prefill_model(pad_head_dim(q, dp), pad_head_dim(kp, dp),
                            pad_head_dim(vp, dp), bt, pos0, seq, window,
                            ks, vs, sm_scale=dh ** -0.5)[..., :dh]
    assert got.shape == q.shape

    def jx(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    jargs = [jx(t) for t in (q, kp, vp, bt)]
    jpos0, jseq = jx(pos0), jx(seq)
    positions = jpos0[:, None] + jnp.arange(q.shape[1], dtype=jnp.int32)
    wants = [jax_prefill_ref(*jargs, jpos0, jseq, window, jx(ks), jx(vs)),
             jax_attend_prefill(*jargs, positions, jpos0, jseq, window,
                                k_scale=jx(ks), v_scale=jx(vs),
                                attn_backend="pallas_interpret")]
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   **TC_TOL)


# -------------------------------------------- the decode kernel's splits
def _split_kv_model(q, kp, vp, bt, pos, window, ks=None, vs=None):
    """The decode kernel's arithmetic in plain torch; q ``(B, 1, Hq, Dh)``
    -> ``(B, 1, Hq, Dh)`` float32.  Per (lane, KV head) and per split of
    ``decode_split_tokens(Dh)`` keys that holds an attended key: q cast as
    the TPU kernel casts it (through bf16 for int8 pools, to the pool dtype
    otherwise), scores in float32 times D^-0.5 (times the K scale), masked
    keys -1e30, m the split's max, l the sum of its float32 p, and p times
    the V scale (int8, not rounded) or rounded to the pool dtype into
    acc = p . v; then the combine in split order: m* = max m_s, w_s =
    exp(m_s - m*), out = sum w_s acc_s / max(sum w_s l_s, 1e-30)."""
    b, _, hq, dh = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    g = hq // hkv
    tokens, splits = pa_kernel.decode_splits(bt.shape[1], page, dh)
    cap = bt.shape[1] * page
    quant = ks is not None
    qf = q.reshape(b, hkv, g, dh).to(torch.bfloat16 if quant
                                     else kp.dtype).float()
    kg, vg = gather_pages(kp, bt).float(), gather_pages(vp, bt).float()
    if quant:
        ksg, vsg = gather_pages(ks, bt).float(), gather_pages(vs, bt).float()
    out = torch.zeros((b, hkv, g, dh))
    for lane in range(b):
        cur = int(pos[lane])
        hi = min(cur + 1, cap)
        lo = max(0, cur - window + 1) if window > 0 else 0
        for h in range(hkv):
            parts = []
            for s in range(splits):
                rows = torch.arange(s * tokens, min((s + 1) * tokens, cap))
                if max(s * tokens, lo) >= min((s + 1) * tokens, hi):
                    continue          # no attended key: never combined
                sc = (qf[lane, h] @ kg[lane, rows, h].T) * dh ** -0.5
                if quant:
                    sc = sc * ksg[lane, rows, h]
                valid = (rows >= lo) & (rows < hi)
                sc = torch.where(valid, sc, torch.tensor(-1e30))
                m = sc.amax(-1)
                p = torch.exp(sc - m[:, None])
                l = p.sum(-1)
                p = (p * vsg[lane, rows, h] if quant
                     else p.to(kp.dtype).float())
                parts.append((m, l, p @ vg[lane, rows, h]))
            if not parts:
                continue
            m_star = torch.stack([m for m, _, _ in parts]).amax(0)
            l_sum = torch.zeros(g)
            o = torch.zeros((g, dh))
            for m, l, acc in parts:
                w = torch.exp(m - m_star)
                l_sum = l_sum + w * l
                o = o + w[:, None] * acc
            out[lane, h] = o / torch.clamp_min(l_sum, 1e-30)[:, None]
    return out.reshape(b, 1, hq, dh)


def _split_case(kind, group, dh, seed):
    """Three lanes over a table of 12 pages of 16 (192 keys, three splits of
    64 at Dh <= 128): one at position 0 (splits 1-2 past it), one at 70,
    one at the last slot (with a window, splits before it)."""
    rng = np.random.default_rng(seed)
    b, hkv, page, nblk = 3, 2, 16, 12
    n_pages = b * nblk + 1
    kp, vp, ks, vs = _pool(rng, n_pages, page, hkv, dh,
                           8 if kind == "int8" else 0)
    bt = (1 + rng.permutation(b * nblk).reshape(b, nblk)).astype(np.int32)
    q = rng.standard_normal((b, 1, hkv * group, dh)).astype(np.float32)
    pos = np.asarray([0, 70, page * nblk - 1], np.int32)
    if kind == "bfloat16":
        q, kp, vp = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
                     for a in (q, kp, vp))
    return q, kp, vp, bt, pos, ks, vs


@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("dh", [16, 112, 128])
@pytest.mark.parametrize("group", [1, 5, 8, 12])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_split_kv_decode_model_matches_jax(kind, group, dh, window):
    q, kp, vp, bt, pos, ks, vs = _split_case(kind, group, dh,
                                             seed=group * 7 + dh + window)
    tokens, splits = pa_kernel.decode_splits(bt.shape[1], kp.shape[1], dh)
    assert (tokens, splits) == (64, 3)
    got = _split_kv_model(_t(q), _t(kp), _t(vp), _t(bt), _t(pos), window,
                          _tx(ks), _tx(vs))
    b, _, hq, _ = q.shape
    hkv = kp.shape[2]
    jq = jnp.asarray(q)
    want_ref = np.asarray(jax_decode_ref(
        jq, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), window, _jx(ks), _jx(vs))).astype(np.float32)
    want_pallas = np.asarray(jax_decode_pallas(
        jq.reshape(b, hkv, hq // hkv, dh), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(pos), jnp.asarray([window], jnp.int32),
        _jx(ks), _jx(vs), interpret=True)).reshape(q.shape)
    if kind == "bfloat16":
        # the output cast to q's dtype, at chip_smoke.py's attn_tol: the
        # split rounds p to bf16 against its own max, and at these sizes
        # (112-wide heads, up to 192 keys) JAX's Pallas kernel, which
        # rounds against a running max, misses its own ref's one-ulp
        # (2^-7, 2^-9) bound too
        got = got.bfloat16().float()
        tols = (TC_TOL, TC_TOL)
    elif kind == "int8":
        tols = (INT8_TOL, dict(rtol=1e-2, atol=1e-2))
    else:
        tols = (F32_TOL, F32_TOL)
    for want, tol in zip((want_ref, want_pallas), tols):
        np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("dh,want", [(16, 64), (64, 64), (112, 64),
                                     (128, 64), (200, 32), (256, 32),
                                     (512, 16)])
def test_decode_split_tokens_by_head_dim(dh, want):
    assert pa_kernel.decode_split_tokens(dh) == want
    assert want * padded_pow2(dh) <= pa_kernel.DECODE_TILE_ELEMS


def padded_pow2(dh):
    width = 32
    while width < dh:
        width *= 2
    return width


@pytest.mark.parametrize("dh", [0, 513])
def test_decode_split_tokens_refuses_head_dims(dh):
    with pytest.raises(ValueError):
        pa_kernel.decode_split_tokens(dh)


@pytest.mark.parametrize("n_blocks", [1, 3, 4, 64, 65, 257])
@pytest.mark.parametrize("page", [1, 16, 32, 100])
@pytest.mark.parametrize("dh", [16, 128, 256])
def test_decode_splits_cover_the_table(n_blocks, page, dh):
    """Every split holds keys of the block table, the last one its end; the
    count follows from the shapes alone (main's 64 x 16 table: 16)."""
    tokens, splits = pa_kernel.decode_splits(n_blocks, page, dh)
    cap = n_blocks * page
    assert (splits - 1) * tokens < cap <= splits * tokens
    assert pa_kernel.decode_splits(n_blocks, page, dh) == (tokens, splits)
    if (n_blocks, page, dh) == (64, 16, 128):
        assert splits == 16
