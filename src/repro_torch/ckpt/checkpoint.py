"""Sharded, integrity-checked checkpoints, in the JAX package's format.

One directory per step::

    step_00000042/
      manifest_<h>.json   magic, step, n_hosts, codec, extra, and for each
                          leaf its path, owner, shape, dtype, offset,
                          nbytes and blake2b (16-byte digest)
      shard_<h>.bin       host h's leaves, concatenated, zstd-compressed
                          (codec "zstd") or as they are (codec "raw")
      COMMITTED           written last

Leaf ``i`` belongs to host ``i % n_hosts``; each host writes its own
leaves into ``step_XXXXXXXX.tmp-<h>``, and host 0 moves every host's files
into the step directory and then commits it.  A step without
``COMMITTED`` is invisible to :func:`latest_step` and refused by
:func:`load_checkpoint`, so a crash between the shards and the commit
leaves the last complete checkpoint the latest.

A tree is nested dicts, lists, tuples and engine ``PackedLinear`` s whose
leaves are tensors, numpy arrays or Python scalars; ``None`` is an empty
subtree.  Leaf paths are the JAX package's
(``jax.tree_util.tree_flatten_with_path``): dict keys in sorted order and
sequence indices, joined by ``/``; a named tuple's fields (the training
loop's ``OptState``) as ``.<field>`` in field order, as JAX names an
attribute; a ``PackedLinear`` is JAX's registered
dataclass, its ``.packed``, ``.scale`` and ``.bias`` in that order (a
stacked expert linear's ``(E, Kp, N)`` codes and ``(E, 1, N)`` scales are
two leaves, as in JAX).  A bfloat16
tensor is written as its raw 2-byte payload under dtype ``"bfloat16"``,
as the JAX package writes one, and read back bit for bit (numpy has no
bfloat16: the payload goes through int16, never through float32).

``zstandard`` is optional, as in the JAX package: without it shards are
written raw and the manifest says so; reading a zstd shard then raises.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import dataclasses

import numpy as np
import torch

from repro_torch.engine.packed import PackedLinear
from repro_torch.tree import is_namedtuple

try:
    import zstandard
except ImportError:  # the card machine has no zstandard
    zstandard = None

Tree = Any

# the data fields of JAX's registered PackedLinear, in its flattening order
_PACKED_FIELDS = ("packed", "scale", "bias")

_MAGIC = "repro-imagine-ckpt-v1"
BF16 = "bfloat16"


class _NullCompressor:
    """Identity codec used when zstandard is unavailable (codec "raw")."""

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes) -> bytes:
        return data


def _compressor():
    return (zstandard.ZstdCompressor(level=3) if zstandard is not None
            else _NullCompressor())


def _decompressor(codec: str):
    if codec == "zstd":
        if zstandard is None:
            raise ImportError(
                "checkpoint was written zstd-compressed but zstandard is "
                "not installed")
        return zstandard.ZstdDecompressor()
    if codec == "raw":
        return _NullCompressor()
    raise ValueError(f"unknown checkpoint codec {codec!r} "
                     "(expected 'zstd' or 'raw')")


def _is_leaf(node) -> bool:
    return not isinstance(node, (dict, list, tuple)) and node is not None


def _leaf_paths(tree: Tree) -> Tuple[List[str], List[Any]]:
    """``(paths, leaves)`` in the JAX package's flattening order."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + [str(k)])
        elif is_namedtuple(node):
            for name, v in zip(node._fields, node):
                walk(v, prefix + ["." + name])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + [str(i)])
        elif isinstance(node, PackedLinear):
            for name in _PACKED_FIELDS:
                walk(getattr(node, name), prefix + ["." + name])
        elif node is not None:
            paths.append("/".join(prefix))
            leaves.append(node)

    walk(tree, [])
    return paths, leaves


def _unflatten(template: Tree, leaves: List[Any]) -> Tree:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: None for k in node}  # the template's key order
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if isinstance(node, PackedLinear):
            return dataclasses.replace(node, **{
                name: build(getattr(node, name)) for name in _PACKED_FIELDS})
        if node is None:
            return None
        return next(it)

    return build(template)


def dtype_name(leaf) -> str:
    """A leaf's dtype as the manifest names it: numpy's name, and
    ``"bfloat16"`` for a bfloat16 tensor."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return BF16
        return str(np.dtype(str(leaf.dtype).removeprefix("torch.")))
    return str(np.asarray(leaf).dtype)


def template_leaf(shape, dtype: str):
    """A zero leaf of a manifest's shape and dtype, for a template: a
    numpy array, or a CPU tensor for ``"bfloat16"``."""
    if dtype == BF16:
        return torch.zeros(tuple(shape), dtype=torch.bfloat16)
    return np.zeros(tuple(shape), dtype=np.dtype(dtype))


def _host_bytes(leaf) -> Tuple[bytes, List[int], str]:
    """A leaf's raw bytes, shape and dtype string (numpy's names; a
    bfloat16 tensor's 2-byte payload under ``"bfloat16"``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), list(t.shape), BF16
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _from_bytes(raw: bytes, dtype: str, shape) -> Any:
    """A stored leaf: a numpy array, or a CPU bfloat16 tensor."""
    if dtype == BF16:
        codes = np.frombuffer(raw, np.int16).reshape(shape).copy()
        return torch.from_numpy(codes).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _like(arr, tmpl, path: str) -> Any:
    """The stored leaf ``arr`` in the template leaf's kind: a tensor of the
    template's dtype on its device, or a numpy array of its dtype."""
    want_shape = (tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor)
                  else np.shape(tmpl))
    if tuple(arr.shape) != want_shape:
        raise ValueError(f"{path}: ckpt shape {tuple(arr.shape)} != "
                         f"template {want_shape}")
    if isinstance(tmpl, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.array(arr))
        return t.to(device=tmpl.device, dtype=tmpl.dtype)
    want = np.asarray(tmpl).dtype
    if isinstance(arr, torch.Tensor):  # bfloat16 into a numpy template
        return arr.float().numpy().astype(want)
    return arr.astype(want) if arr.dtype != want else arr


def _commit(final: str) -> None:
    """Mark a step directory complete: the last write of a save."""
    tmp = os.path.join(final, "COMMITTED.tmp")
    with open(tmp, "w") as f:
        f.write(_MAGIC)
    os.replace(tmp, os.path.join(final, "COMMITTED"))


def save_checkpoint(
    directory: str,
    step: int,
    tree: Tree,
    *,
    host_id: int = 0,
    n_hosts: int = 1,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write host ``host_id``'s leaves of ``tree`` for ``step``; host 0
    (which saves last) moves every host's files into place and commits.
    Returns the step directory."""
    paths, leaves = _leaf_paths(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{host_id}"
    os.makedirs(tmp, exist_ok=True)

    manifest = {"magic": _MAGIC, "step": step, "n_hosts": n_hosts,
                "codec": "zstd" if zstandard is not None else "raw",
                "extra": extra or {}, "leaves": []}
    blob = bytearray()
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        if i % n_hosts != host_id:
            manifest["leaves"].append({"path": p, "owner": i % n_hosts})
            continue
        raw, shape, dtype = _host_bytes(leaf)
        manifest["leaves"].append({
            "path": p,
            "owner": host_id,
            "shape": shape,
            "dtype": dtype,
            "offset": len(blob),
            "nbytes": len(raw),
            "blake2b": hashlib.blake2b(raw, digest_size=16).hexdigest(),
        })
        blob.extend(raw)
    with open(os.path.join(tmp, f"shard_{host_id}.bin"), "wb") as f:
        f.write(_compressor().compress(bytes(blob)))
    with open(os.path.join(tmp, f"manifest_{host_id}.json"), "w") as f:
        json.dump(manifest, f)

    if host_id == 0:
        os.makedirs(final, exist_ok=True)
        for h in range(n_hosts):
            hdir = final + f".tmp-{h}"
            if not os.path.isdir(hdir):
                continue
            for name in os.listdir(hdir):
                shutil.move(os.path.join(hdir, name),
                            os.path.join(final, name))
            os.rmdir(hdir)
        _commit(final)
    return final


def read_manifest(directory: str, step: int, host: int = 0) -> Dict:
    """Host ``host``'s manifest of a step directory."""
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, f"manifest_{host}.json")) as f:
        return json.load(f)


def load_checkpoint(
    directory: str,
    template: Tree,
    step: Optional[int] = None,
) -> Tuple[Tree, Dict[str, Any]]:
    """Restore ``step`` (None: the latest committed) into the structure of
    ``template``: each leaf in its template leaf's kind and dtype (a
    tensor on its device, or a numpy array).  Every leaf's blake2b is
    checked.  Returns ``(tree, extra)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    final = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(final, "COMMITTED")):
        raise FileNotFoundError(f"checkpoint {final} not committed")

    manifests = {}
    for name in os.listdir(final):
        if name.startswith("manifest_"):
            with open(os.path.join(final, name)) as f:
                m = json.load(f)
            if m.get("magic") != _MAGIC:
                raise ValueError(f"{final}/{name}: not a {_MAGIC} manifest")
            manifests[int(name.split("_")[1].split(".")[0])] = m

    paths, leaves = _leaf_paths(template)
    by_path: Dict[str, Tuple[int, dict]] = {}
    for h, m in manifests.items():
        for entry in m["leaves"]:
            if "offset" in entry:
                by_path[entry["path"]] = (h, entry)

    blobs = {}
    for h, m in manifests.items():
        dctx = _decompressor(m.get("codec", "zstd"))
        with open(os.path.join(final, f"shard_{h}.bin"), "rb") as f:
            blobs[h] = dctx.decompress(f.read())

    out = []
    for p, leaf in zip(paths, leaves):
        if p not in by_path:
            raise KeyError(f"{p}: not in checkpoint step {step}")
        h, entry = by_path[p]
        raw = blobs[h][entry["offset"]:entry["offset"] + entry["nbytes"]]
        digest = hashlib.blake2b(raw, digest_size=16).hexdigest()
        if digest != entry["blake2b"]:
            raise IOError(f"checksum mismatch for {p} in step {step}")
        out.append(_like(_from_bytes(raw, entry["dtype"], entry["shape"]),
                         leaf, p))
    extra = manifests[min(manifests)]["extra"]
    return _unflatten(template, out), extra


def latest_step(directory: str) -> Optional[int]:
    """The highest committed step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp" not in name:
            if os.path.exists(os.path.join(directory, name, "COMMITTED")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None
