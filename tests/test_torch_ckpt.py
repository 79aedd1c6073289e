"""PyTorch port vs JAX: ``repro_torch.ckpt``, the checkpoint format.

The six checkpoint cases of ``tests/test_ckpt_ft.py`` (roundtrip,
multi-host, corruption, uncommitted invisible, rotation and resume, async
save) on a tree of tensors, then the format across the two packages:
leaf paths equal to ``jax.tree_util.tree_flatten_with_path``'s, a
checkpoint written by JAX loaded by the port and one written by the port
loaded by JAX, under both codecs (``zstd``, and ``raw`` with
``zstandard`` hidden), bfloat16 leaves bit for bit.  Every comparison is
exact: a checkpoint stores bytes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as jckpt
from repro.ckpt import load_checkpoint as j_load, save_checkpoint as j_save

import repro_torch.ckpt.checkpoint as tckpt
from repro_torch.ckpt import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)


def _values(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    # bfloat16 payloads: float32 values whose low 16 bits are zero
    b = (rng.standard_normal(16).astype(np.float32).view(np.uint32)
         & 0xFFFF0000).view(np.float32)
    return w, b


def _tree(seed=0):
    w, b = _values(seed)
    return {"params": {"w": torch.from_numpy(w),
                       "b": torch.from_numpy(b).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _jax_tree(seed=0):
    w, b = _values(seed)
    return {"params": {"w": jnp.asarray(w),
                       "b": jnp.asarray(b).astype(jnp.bfloat16)},
            "step": jnp.asarray(7, jnp.int32)}


def _zeros_like(tree):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "step": torch.zeros_like(tree["step"])}


def _assert_trees_equal(a, b):
    pa, la = tckpt._leaf_paths(a)
    pb, lb = tckpt._leaf_paths(b)
    assert pa == pb
    for p, x, y in zip(pa, la, lb):
        assert x.dtype == y.dtype, p
        assert torch.equal(x, y), p


@pytest.fixture(params=["zstd", "raw"])
def codec(request, monkeypatch):
    """Both packages write ``request.param``: ``raw`` hides zstandard from
    both modules."""
    if request.param == "raw":
        monkeypatch.setattr(jckpt, "zstandard", None)
        monkeypatch.setattr(tckpt, "zstandard", None)
    else:
        assert tckpt.zstandard is not None and jckpt.zstandard is not None
    return request.param


# --------------------------------------------- test_ckpt_ft.py's six
class TestCheckpoint:
    def test_roundtrip(self, tmp_path, codec):
        tree = _tree()
        save_checkpoint(str(tmp_path), 5, tree, extra={"data_step": 5})
        out, extra = load_checkpoint(str(tmp_path), _zeros_like(tree))
        assert extra["data_step"] == 5
        _assert_trees_equal(tree, out)
        assert tckpt.read_manifest(str(tmp_path), 5)["codec"] == codec

    def test_multi_host_roundtrip(self, tmp_path):
        tree = _tree(1)
        # hosts write their leaf shards; host 0 last to finalize
        for h in (1, 2, 0):
            save_checkpoint(str(tmp_path), 3, tree, host_id=h, n_hosts=3)
        final = tmp_path / "step_00000003"
        assert sorted(os.listdir(final)) == [
            "COMMITTED", "manifest_0.json", "manifest_1.json",
            "manifest_2.json", "shard_0.bin", "shard_1.bin", "shard_2.bin"]
        owners = [e["owner"] for e in tckpt.read_manifest(
            str(tmp_path), 3, host=1)["leaves"]]
        assert owners == [0, 1, 2]  # leaf i on host i % 3
        out, _ = load_checkpoint(str(tmp_path), _zeros_like(tree))
        _assert_trees_equal(tree, out)

    def test_corruption_detected(self, tmp_path, codec):
        tree = _tree()
        path = save_checkpoint(str(tmp_path), 1, tree)
        shard = os.path.join(path, "shard_0.bin")
        blob = bytearray(open(shard, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(shard, "wb").write(bytes(blob))
        with pytest.raises(Exception):
            load_checkpoint(str(tmp_path), tree)

    def test_uncommitted_invisible(self, tmp_path):
        tree = _tree()
        path = save_checkpoint(str(tmp_path), 2, tree)
        os.remove(os.path.join(path, "COMMITTED"))
        assert latest_step(str(tmp_path)) is None
        with pytest.raises(FileNotFoundError):
            load_checkpoint(str(tmp_path), tree, step=2)

    def test_manager_rotation_and_resume(self, tmp_path):
        tree = _tree()
        mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
        for s in (10, 20, 30):
            mgr.save(s, tree)
        steps = sorted(int(n.split("_")[1])
                       for n in os.listdir(tmp_path) if n.startswith("step_"))
        assert steps == [20, 30]
        step, out, _ = mgr.restore_latest(_zeros_like(tree))
        assert step == 30
        _assert_trees_equal(tree, out)

    def test_async_save(self, tmp_path):
        tree = _tree()
        mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
        mgr.save(1, tree)
        mgr.wait()
        assert latest_step(str(tmp_path)) == 1


def test_async_save_copies_before_the_thread(tmp_path):
    """The tree is copied to the host when ``save`` is called: an in-place
    update right after it does not reach the checkpoint."""
    tree = _tree()
    want = {k: v.clone() for k, v in tree["params"].items()}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(4, tree)
    tree["params"]["w"].add_(1.0)
    tree["params"]["b"].zero_()
    _, out, _ = mgr.restore_latest(_zeros_like(tree))
    for k, v in want.items():
        assert torch.equal(out["params"][k], v), k


def test_async_save_failure_raises_from_wait(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr("repro_torch.ckpt.manager.save_checkpoint", broken)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # reported once


def test_crash_before_commit_leaves_no_visible_step(tmp_path, monkeypatch):
    """A save that dies after its shards and manifest are in place but
    before ``COMMITTED`` is written leaves the previous step the latest;
    the half-written step cannot be loaded."""
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)

    def crash(final):
        raise KeyboardInterrupt("killed")

    monkeypatch.setattr(tckpt, "_commit", crash)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(str(tmp_path), 2, _tree(5))
    assert (tmp_path / "step_00000002" / "shard_0.bin").exists()
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError, match="not committed"):
        load_checkpoint(str(tmp_path), tree, step=2)
    out, _ = load_checkpoint(str(tmp_path), _zeros_like(tree))
    _assert_trees_equal(tree, out)


def test_zstd_shard_without_zstandard_raises(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 1, _tree())
    assert tckpt.read_manifest(str(tmp_path), 1)["codec"] == "zstd"
    monkeypatch.setattr(tckpt, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard is not installed"):
        load_checkpoint(str(tmp_path), _tree())


def test_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="ckpt shape"):
        load_checkpoint(str(tmp_path), {"w": torch.zeros((3, 2))})


# ------------------------------------------------ across the packages
def test_leaf_paths_match_jax():
    """Nested dicts (sorted keys, numeric-looking ones too), lists, tuples
    and a None subtree flatten to JAX's paths, in JAX's order."""
    arr = np.zeros(2, np.float32)
    tree = {"z": [arr, (arr, {"b": arr, "a": arr})], "a": {"10": arr,
                                                          "9": arr},
            "m": None, "k": 3}
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp) for kp, _ in flat]
    paths, leaves = tckpt._leaf_paths(tree)
    assert paths == want
    assert len(leaves) == len(flat)
    numbers = list(range(len(leaves)))
    assert (tckpt._unflatten(tree, numbers)
            == jax.tree_util.tree_unflatten(treedef, numbers))


def test_jax_writes_port_reads(tmp_path, codec):
    jtree = _jax_tree(2)
    j_save(str(tmp_path), 9, jtree, extra={"by": "jax"})
    assert tckpt.read_manifest(str(tmp_path), 9)["codec"] == codec
    out, extra = load_checkpoint(str(tmp_path), _zeros_like(_tree()))
    assert extra == {"by": "jax"}
    _assert_trees_equal(_tree(2), out)
    # the bfloat16 leaf bit for bit
    jb = np.asarray(jtree["params"]["b"]).view(np.int16)
    assert np.array_equal(out["params"]["b"].view(torch.int16).numpy(), jb)


def test_port_writes_jax_reads(tmp_path, codec):
    tree = _tree(3)
    save_checkpoint(str(tmp_path), 4, tree, extra={"by": "port"})
    jtree = _jax_tree(3)
    out, extra = j_load(str(tmp_path), jax.tree.map(jnp.zeros_like, jtree))
    assert extra == {"by": "port"}
    assert str(out["params"]["b"].dtype) == "bfloat16"
    assert np.array_equal(np.asarray(out["params"]["b"]).view(np.int16),
                          tree["params"]["b"].view(torch.int16).numpy())
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_multi_host_across_packages(tmp_path):
    """Hosts 1 and 2 are the JAX package, host 0 (which commits) the
    port: one checkpoint, loaded by both."""
    for h in (1, 2):
        j_save(str(tmp_path), 6, _jax_tree(4), host_id=h, n_hosts=3)
    save_checkpoint(str(tmp_path), 6, _tree(4), host_id=0, n_hosts=3)
    out, _ = load_checkpoint(str(tmp_path), _zeros_like(_tree()))
    _assert_trees_equal(_tree(4), out)
    jout, _ = j_load(str(tmp_path), jax.tree.map(jnp.zeros_like,
                                                 _jax_tree()))
    for a, b in zip(jax.tree.leaves(_jax_tree(4)), jax.tree.leaves(jout)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_numpy_templates_and_scalars(tmp_path):
    """Numpy leaves and Python scalars round-trip as numpy arrays; a
    bfloat16 leaf loaded into a float32 numpy template widens exactly."""
    tree = {"a": np.arange(6, dtype=np.int64).reshape(2, 3), "s": 2.5,
            "b": _tree()["params"]["b"]}
    save_checkpoint(str(tmp_path), 1, tree)
    tmpl = {"a": np.zeros((2, 3), np.int64), "s": 0.0,
            "b": np.zeros(16, np.float32)}
    out, _ = load_checkpoint(str(tmp_path), tmpl)
    np.testing.assert_array_equal(out["a"], tree["a"])
    assert float(out["s"]) == 2.5
    np.testing.assert_array_equal(out["b"], tree["b"].float().numpy())


# ------------------------------------- the audio and hybrid families' trees
def _family_trees(arch):
    """A reduced ``arch`` (bf16, 4-bit linears) as both packages hold it:
    every top-level leaf (musicgen's ``(K, V, D)`` embedding and ``V·K``
    head, zamba2's ``shared_attn`` block) and the first layer, plus a
    step counter."""
    import dataclasses

    from repro.config import get_reduced
    from repro.models import init_params
    from repro.models.transformer import quantize_params

    from repro_torch.weights import params_from_numpy
    from test_torch_model import jax_params_to_numpy, torch_cfg

    cfg = get_reduced(arch)
    jp = quantize_params(init_params(cfg, jax.random.PRNGKey(0)), cfg, 4)
    tp = params_from_numpy(jax_params_to_numpy(jp), torch_cfg(cfg),
                           device="cpu")
    jtree = {k: v for k, v in jp.items() if k != "layers"}
    jtree["layer0"] = jax.tree.map(lambda a: a[0], jp["layers"])
    jtree["step"] = jnp.asarray(11, jnp.int32)
    ttree = {k: v for k, v in tp.items() if k != "layers"}
    ttree["layer0"] = tp["layers"][0]
    ttree["step"] = torch.tensor(11, dtype=torch.int32)

    def zeros(node):
        if isinstance(node, dict):
            return {k: zeros(v) for k, v in node.items()}
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(
                node, packed=torch.zeros_like(node.packed),
                scale=torch.zeros_like(node.scale),
                bias=None if node.bias is None else torch.zeros_like(
                    node.bias))
        return torch.zeros_like(node)

    return jtree, ttree, zeros(ttree)


def _assert_port_trees_equal(a, b):
    pa, la = tckpt._leaf_paths(a)
    pb, lb = tckpt._leaf_paths(b)
    assert pa == pb
    for p, x, y in zip(pa, la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


@pytest.mark.parametrize("arch", ["zamba2-7b", "musicgen-medium"])
def test_family_tree_jax_writes_port_reads(tmp_path, codec, arch):
    """A reduced zamba2 tree (the shared block's packed linears) and a
    reduced musicgen tree (the per-codebook embedding, the ``V·K`` head)
    saved by JAX load byte-equal into the port, on the same leaf paths."""
    jtree, ttree, template = _family_trees(arch)
    assert tckpt._leaf_paths(ttree)[0] == jckpt._leaf_paths(jtree)[0]
    j_save(str(tmp_path), 3, jtree)
    out, _ = load_checkpoint(str(tmp_path), template)
    _assert_port_trees_equal(out, ttree)
    if arch == "musicgen-medium":
        assert out["embed"].ndim == 3 and out["embed"].dtype == torch.bfloat16
    else:
        assert out["shared_attn"]["attn"]["wq"].bits == 4


@pytest.mark.parametrize("arch", ["zamba2-7b", "musicgen-medium"])
def test_family_tree_port_writes_jax_reads(tmp_path, codec, arch):
    """The same trees saved by the port load byte-equal into JAX."""
    jtree, ttree, _ = _family_trees(arch)
    save_checkpoint(str(tmp_path), 4, ttree)
    out, _ = j_load(str(tmp_path), jax.tree.map(jnp.zeros_like, jtree))
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(out)):
        assert str(a.dtype) == str(b.dtype)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
