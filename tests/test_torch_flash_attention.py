"""PyTorch port vs JAX: flash attention.

The same numpy-seeded float32 inputs go through

* the port's plain version (``kernels/flash_attention/ref.py``) and JAX
  ``flash_attention_ref``, in ``(B, H, S, D)`` layout;
* the port's ``ops.flash_attention`` on CPU tensors (which runs the plain
  version) and JAX ``flash_attention(..., interpret=True)``, the Pallas
  kernel interpreted on the CPU, in the model's ``(B, S, H, D)`` layout,
  over the block sizes of ``tests/test_flash_kernel.py`` and a length that
  is not a block multiple (JAX pads, the port does not);
* the port's ``attend_flash`` (plain chunked online softmax) and JAX
  ``attend_flash`` (its jnp path), at the model's blocks and small ones.

Tolerance: rtol = atol = 1e-5, the one ``tests/test_flash_kernel.py``
holds the Pallas kernel to against dense attention (float32 sums in
another order; online vs one-shot softmax).

The CUDA kernel's two routes (``kernel.route``: ``tensor_core`` for
bfloat16, ``cuda_core`` for float32) run only on the card
(``tests/test_torch_cuda_kernels.py``).  Here the tensor-core route's
arithmetic is modelled in plain torch (``_tc_model``: 64-row query tiles,
64-key online-softmax steps, bf16 products summed in float32, p split into
bf16 hi + lo) and held against JAX ``flash_attention_ref`` on bf16 inputs
at ``chip_smoke.py``'s bf16 tolerance (``flash_tol``: rtol 2^-7, one bf16
ulp of the value, atol 1e-5); a model that rounds p to bf16 once misses
that tolerance, which is why the kernel splits p.  Both routes take the
head dims 32 / 64 / 128; the launcher zero-pads any other D up to 128 to
the next of them and passes the scale of the true D (``kernels/_heads.py``):
D = 16 and 112 go through that padding into the tensor-core model (bf16)
and into plain float32 attention (the CUDA-core route's function), against
JAX at the tolerances above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models.attention import attend_flash as jax_attend_flash

from repro_torch.kernels._heads import pad_head_dim, padded_head_dim
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, route
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.attention import attend_flash

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)   # chip_smoke.py's flash_tol
TILE = 64   # query rows a block and keys a step of the CUDA kernel


def _qkv(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d), dtype=np.float32),
            rng.standard_normal((b, s, hkv, d), dtype=np.float32),
            rng.standard_normal((b, s, hkv, d), dtype=np.float32))


def _bhsd(a):
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("s", [256, 200])
def test_ref_matches_jax_ref(window, group, s):
    q, k, v = (_bhsd(a) for a in _qkv(2, s, 2 * group, 2, 32, seed=s))
    out = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window)
    ref = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128)])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("s", [256, 200])
def test_ops_matches_jax_interpret(bq, bk, window, group, s):
    q, k, v = _qkv(1, s, 2 * group, 2, 16, seed=7 * s + group)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=window)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    window=window, block_q=bq, block_kv=bk, interpret=True)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("window", [0, 5, 64])
@pytest.mark.parametrize("s,bq,bk", [(64, 512, 1024), (96, 32, 64),
                                     (100, 32, 64), (77, 16, 16)])
def test_attend_flash_matches_jax(window, s, bq, bk):
    q, k, v = _qkv(2, s, 4, 2, 16, seed=s + window)
    rng = np.random.default_rng(s)
    # positions offset per row, as a prompt continued from a prefix
    positions = (np.arange(s)[None, :]
                 + rng.integers(0, 9, (2, 1))).astype(np.int32)
    out = attend_flash(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(positions),
                       window, bq, bk)
    ref = jax_attend_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(positions), window, bq, bk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_attend_flash_kernel_route_on_cpu_matches_plain():
    """``attn_backend="cuda"`` on CPU tensors goes through
    ``ops.flash_attention``, which runs the plain version: the same
    function as the chunked path at positions 0..S-1."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 90, 8, 2, 32, seed=3))
    pos = torch.arange(90, dtype=torch.int32).expand(2, 90)
    for window in (0, 17):
        a = attend_flash(q, k, v, pos, window, 32, 32, attn_backend="cuda",
                         sequential=True)
        b = attend_flash(q, k, v, pos, window, 32, 32)
        torch.testing.assert_close(a, b, **TOL)


def test_attend_flash_kernel_route_refuses_given_positions():
    """The kernel masks by index from 0: without the caller's word that
    positions are 0..S-1 it raises instead of ignoring them."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 16))
    pos = torch.arange(16, dtype=torch.int32)[None] + 3
    with pytest.raises(NotImplementedError, match="positions"):
        attend_flash(q, k, v, pos, 0, attn_backend="cuda")


# ------------------------------------------------ the tensor-core route
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "tensor_core"),
                                        (torch.float32, "cuda_core")])
def test_route_by_dtype(dtype, want, d):
    assert route(dtype, d) == want


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 160),
                                     (torch.float32, 256),
                                     (torch.float16, 128)])
def test_route_refuses_what_no_design_takes(dtype, d):
    with pytest.raises(ValueError):
        route(dtype, d)


@pytest.mark.parametrize("d,width", [(1, 32), (16, 32), (33, 64),
                                     (96, 128), (112, 128), (128, 128)])
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "tensor_core"),
                                        (torch.float32, "cuda_core")])
def test_route_takes_every_head_dim_up_to_128(dtype, want, d, width):
    assert route(dtype, d) == want
    assert padded_head_dim(d, "flash_attention_cuda") == width


def _tc_model(q, k, v, window, split, sm_scale=None):
    """The tensor-core route's arithmetic in plain torch; q ``(B, Hq, S,
    D)``, k/v ``(B, Hkv, S, D)``, bf16 in and out.  Per 64-row query tile,
    an online softmax over the 64-key tiles some row attends: bf16 products
    summed in float32, scores times ``sm_scale`` (D^-0.5 by default),
    masked scores -1e30, l summing
    the float32 p, and p into p . v as bf16 hi + lo (``split``) or rounded
    to bf16 once."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    pos = torch.arange(s)
    neg = torch.tensor(-1e30)
    out = torch.empty_like(qf)
    for q0 in range(0, s, TILE):
        rows = pos[q0:q0 + TILE]
        m = torch.full((b, hq, len(rows)), -1e30)
        l = torch.zeros((b, hq, len(rows)))
        o = torch.zeros((b, hq, len(rows), d))
        kt_lo = max(0, q0 - window + 1) // TILE if window > 0 else 0
        for k0 in range(kt_lo * TILE, int(rows[-1]) + 1, TILE):
            cols = pos[k0:k0 + TILE]
            sc = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) \
                * (d ** -0.5 if sm_scale is None else sm_scale)
            mask = cols[None, :] <= rows[:, None]
            if window > 0:
                mask = mask & (cols[None, :] > rows[:, None] - window)
            sc = torch.where(mask, sc, neg)
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * corr + p.sum(-1)
            m = m_new
            hi = p.bfloat16().float()
            o = o * corr[..., None] + hi @ vf[:, :, cols]
            if split:
                o = o + (p - hi).bfloat16().float() @ vf[:, :, cols]
        out[:, :, rows] = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def _bf16_case(b, s, hq, hkv, d, seed):
    """bf16 q, k, v ``(B, H, S, D)`` for the port and the same values for
    JAX."""
    q, k, v = (torch.from_numpy(_bhsd(a)).bfloat16()
               for a in _qkv(b, s, hq, hkv, d, seed=seed))
    jx = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)]
    return (q, k, v), jx


def _share_of_tol(got, want):
    """The largest |got - want| / (atol + rtol |want|) at BF16_TOL."""
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    bound = BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(want)
    return float((np.abs(got - want) / bound).max())


@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", [(4, 2), (2, 2)])
def test_tensor_core_model_matches_jax_ref(hq, hkv, d, window):
    """S = 200 (ragged against the 64-row tiles), GQA groups 2 and 1."""
    (q, k, v), jx = _bf16_case(1, 200, hq, hkv, d, seed=d + window + hq)
    got = _tc_model(q, k, v, window, split=True)
    want = jax_ref(*jx, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **BF16_TOL)


def test_bf16_p_misses_the_tolerance_the_split_meets():
    """Why the kernel splits p: rounded to bf16 once, p . v misses the
    one-ulp bf16 tolerance many times over on the same inputs that the
    hi + lo split holds."""
    (q, k, v), jx = _bf16_case(1, 256, 4, 2, 64, seed=1)
    want = jax_ref(*jx, window=0)
    assert _share_of_tol(_tc_model(q, k, v, 0, split=True), want) <= 1.0
    assert _share_of_tol(_tc_model(q, k, v, 0, split=False), want) > 10.0


@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("d", [16, 112])
def test_tensor_core_model_pads_head_dim(d, window):
    """The launcher's padding into the tensor-core route's arithmetic:
    q, k, v zero-padded to the tiles' width, the scale of the true D, the
    output sliced back, against JAX's ref at the bf16 tolerance."""
    (q, k, v), jx = _bf16_case(1, 200, 4, 2, d, seed=d + window)
    dp = padded_head_dim(d, "flash_attention_cuda")
    got = _tc_model(*(pad_head_dim(t, dp) for t in (q, k, v)), window,
                    split=True, sm_scale=d ** -0.5)[..., :d]
    assert got.shape == q.shape
    want = jax_ref(*jx, window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **BF16_TOL)


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("d", [16, 112])
def test_float32_padding_matches_jax_interpret(d, window):
    """The CUDA-core route's function on padded float32 inputs (masked
    softmax attention with the scale of the true D, in float32), sliced
    back, against JAX's Pallas kernel in interpret mode."""
    q, k, v = _qkv(1, 200, 4, 2, d, seed=5 * d + window)
    dp = padded_head_dim(d, "flash_attention_cuda")
    qp, kp, vp = (pad_head_dim(torch.from_numpy(_bhsd(a)), dp)
                  for a in (q, k, v))
    kp, vp = (t.repeat_interleave(2, 1) for t in (kp, vp))
    sc = (qp @ kp.transpose(-1, -2)) * d ** -0.5
    pos = torch.arange(200)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    sc = torch.where(mask, sc, torch.tensor(-1e30))
    got = (torch.softmax(sc, -1) @ vp)[..., :d].transpose(1, 2)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     window=window, block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
