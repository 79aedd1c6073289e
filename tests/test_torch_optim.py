"""PyTorch port vs JAX: ``repro_torch.optim`` — AdamW, Adafactor and SGD,
the cosine-warmup schedule and int8 error-feedback gradient compression.

Both packages get the same numpy params, grads and optimizer state (a
tree with 1-D, 2-D and stacked 3-D leaves, as the training loop holds
them); three updates in a row are compared leaf by leaf.

Tolerance: params, moments and factored second moments within atol 1e-6
plus rtol 1e-6 (float32 arithmetic in the same order; XLA may contract a
multiply-add where PyTorch rounds twice).  Adam's update divides the
moment by the root of the second moment: a gradient far below eps would
make that ratio sensitive to the last bit, so the grads here are of
order 1e-2 to 1.  The schedule within two float32 ulps (rtol 2.5e-7:
XLA's and PyTorch's ``cos`` may differ in the last bit), the compression
round trip within 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
from repro.config.base import TrainConfig as JTrainConfig

import repro_torch.optim as topt
from repro_torch.config import TrainConfig
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"embed": (12, 8), "final_norm": (8,),
          "layers": {"w": (3, 8, 6), "ln": (3, 8), "b": (3, 6)}}


def _np_tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return (scale * rng.standard_normal(node)).astype(np.float32)

    return make(shapes)


def _torch(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _assert_close(ttree, jtree, **tol):
    tl = tree_leaves(ttree)
    jl = jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), **(tol or TOL))


def _run_both(name, dtype=("float32", torch.float32, jnp.float32),
              cfg_kw=None, steps=3):
    cfg_kw = cfg_kw or {}
    _, tdt, jdt = dtype
    params = _np_tree(0)
    tp, jp = _torch(params, tdt), _jax(params, jdt)
    tinit, tupd = topt.make_optimizer(name)
    jinit, jupd = jopt.make_optimizer(name)
    ts, js = tinit(tp), jinit(jp)
    tcfg, jcfg = TrainConfig(**cfg_kw), JTrainConfig(**cfg_kw)
    for i in range(steps):
        grads = _np_tree(10 + i, scale=0.1)
        lr_t = topt.cosine_warmup(ts.step, 1e-2, 2, 10)
        lr_j = jopt.cosine_warmup(js.step, 1e-2, 2, 10)
        tp, ts = tupd(_torch(grads, tdt), ts, tp, tcfg, lr_t)
        jp, js = jupd(_jax(grads, jdt), js, jp, jcfg, lr_j)
    return tp, ts, jp, js


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_update_matches_jax(name):
    tp, ts, jp, js = _run_both(name)
    _assert_close(tp, jp)
    _assert_close(ts.inner, js.inner)
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_bf16_params_keep_float32_state(name):
    """bf16 params: the state is float32 (AdamW's moments whatever the
    param dtype) and the updated params round to bf16 as JAX's do."""
    tp, ts, jp, js = _run_both(
        name, ("bfloat16", torch.bfloat16, jnp.bfloat16))
    for leaf in tree_leaves(ts.inner):
        assert leaf.dtype == torch.float32
    for leaf in tree_leaves(tp):
        assert leaf.dtype == torch.bfloat16
    # one bf16 ulp where a float32 difference in the last bit rounds the
    # other way
    _assert_close(tp, jp, rtol=2 ** -7, atol=1e-6)
    _assert_close(ts.inner, js.inner, rtol=1e-5, atol=1e-6)


def test_adamw_weight_decay_and_betas_match_jax():
    kw = dict(weight_decay=0.3, beta1=0.8, beta2=0.99, eps=1e-6)
    tp, ts, jp, js = _run_both("adamw", cfg_kw=kw)
    _assert_close(tp, jp)
    _assert_close(ts.inner, js.inner)


def test_adafactor_factors_stacked_leaves():
    """A stacked ``(L, K, N)`` leaf keeps ``(L, K)`` row and ``(L, N)``
    column factors, a 1-D leaf a full second moment, as in JAX."""
    ts = topt.adafactor_init(_torch(_np_tree(0)))
    js = jopt.adafactor_init(_jax(_np_tree(0)))
    assert tuple(ts.inner["layers"]["w"]["vr"].shape) == (3, 8)
    assert tuple(ts.inner["layers"]["w"]["vc"].shape) == (3, 6)
    assert set(ts.inner["final_norm"]) == {"v"}
    assert (jax.tree.map(np.shape, js.inner)
            == tree_map(lambda t: tuple(t.shape), ts.inner))


def test_updates_write_in_place_and_return_the_same_tensors():
    """The step updates params and state in place, as JAX's donated step
    reuses their buffers."""
    tp = _torch(_np_tree(0))
    ts = topt.adamw_init(tp)
    before = [t.data_ptr() for t in tree_leaves(tp)]
    m0 = ts.inner["m"]["embed"]
    new_p, new_s = topt.adamw_update(_torch(_np_tree(1, 0.1)), ts, tp,
                                     TrainConfig(), torch.tensor(1e-3))
    assert [t.data_ptr() for t in tree_leaves(new_p)] == before
    assert new_s.inner["m"]["embed"] is m0
    assert float(m0.abs().sum()) > 0
    assert isinstance(new_s, topt.OptState) and new_s._fields == (
        "step", "inner")


def test_make_optimizer_names():
    assert topt.make_optimizer("adamw") == (topt.adamw_init,
                                            topt.adamw_update)
    with pytest.raises(KeyError, match="unknown optimizer"):
        topt.make_optimizer("lion")
    assert topt.__all__ == jopt.__all__


@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 5), (4, 20),
                                          (10, 10)])
def test_cosine_warmup_matches_jax(warmup, total):
    steps = np.arange(total + 6, dtype=np.int32)
    t = topt.cosine_warmup(torch.from_numpy(steps), 3e-4, warmup, total)
    j = jopt.cosine_warmup(jnp.asarray(steps), 3e-4, warmup, total)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.5e-7,
                               atol=0)
    # the first optimizer step is not a no-op
    assert float(topt.cosine_warmup(0, 3e-4, warmup, total)) > 0


@pytest.mark.parametrize("bits", [8, 4])
def test_compress_decompress_matches_jax(bits):
    g = np.random.default_rng(3).standard_normal((7, 9)).astype(np.float32)
    t = topt.compress_decompress(torch.from_numpy(g), bits)
    j = jopt.compress_decompress(jnp.asarray(g), bits)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-7, atol=0)
    zero = topt.compress_decompress(torch.zeros(3), bits)
    assert torch.equal(zero, torch.zeros(3))


def test_error_feedback_matches_jax_and_is_unbiased():
    """Three rounds of error feedback: the sent grads and the buffer equal
    JAX's, and sent + buffer' == grads + buffer at every round."""
    tg0 = _torch(_np_tree(5, 0.1))
    tef, jef = topt.ef_state_init(tg0), jopt.ef_state_init(_jax(
        _np_tree(5, 0.1)))
    for i in range(3):
        g = _np_tree(5 + i, 0.1)
        ts, tef_new = topt.error_feedback_compress(_torch(g), tef, 8)
        js, jef = jopt.error_feedback_compress(_jax(g), jef, 8)
        _assert_close(ts, js, rtol=1e-6, atol=1e-7)
        _assert_close(tef_new, jef, rtol=1e-5, atol=1e-7)
        for s, e1, gg, e0 in zip(tree_leaves(ts), tree_leaves(tef_new),
                                 tree_leaves(_torch(g)), tree_leaves(tef)):
            torch.testing.assert_close(s + e1, gg + e0, rtol=0, atol=1e-6)
        tef = tef_new
