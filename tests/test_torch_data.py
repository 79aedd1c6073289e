"""PyTorch port vs JAX: ``repro_torch.data.DataPipeline``, a numpy copy of
the JAX package's pipeline.  For any (seed, step, host) both yield the
same numpy batches bit for bit — tokens and labels, the audio family's
``(B, S, K)`` codebooks, the vlm family's ``img_embeds`` — from the
synthetic source and from a memmap token file, for 2 hosts; the stream
position restores from a checkpoint's dict; the prefetch thread never
drops a batch and re-raises a worker's exception.  Every comparison is
exact."""

import time

import numpy as np
import pytest

from repro.config import get_reduced as j_reduced
from repro.data import DataPipeline as JPipeline

from repro_torch.config import get_reduced
from repro_torch.data import DataPipeline, PipelineState

ARCHS = {"dense": "qwen2.5-3b", "audio": "musicgen-medium",
         "vlm": "llava-next-mistral-7b"}


def _pair(family, **kw):
    arch = ARCHS[family]
    return (DataPipeline(get_reduced(arch), **kw),
            JPipeline(j_reduced(arch), **kw))


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("host", [0, 1])
@pytest.mark.parametrize("family", list(ARCHS))
def test_batches_equal_jax_bit_for_bit(family, host):
    t, j = _pair(family, batch=4, seq_len=16, seed=3, host_id=host,
                 n_hosts=2)
    assert t.batch == j.batch == 2
    for step in (0, 1, 7, 1000):
        _assert_same(t.batch_at(step), j.batch_at(step))
    b = t.batch_at(0)
    if family == "audio":
        assert b["tokens"].shape == (2, 16, t.cfg.n_codebooks)
    if family == "vlm":
        assert b["img_embeds"].shape == (2, t.cfg.img_tokens,
                                         t.cfg.d_model)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_hosts_read_disjoint_shards():
    a, _ = _pair("dense", batch=4, seq_len=16, host_id=0, n_hosts=2)
    b, _ = _pair("dense", batch=4, seq_len=16, host_id=1, n_hosts=2)
    assert not np.array_equal(a.batch_at(0)["tokens"],
                              b.batch_at(0)["tokens"])


@pytest.mark.parametrize("host", [0, 1])
def test_memmap_source_equals_jax(tmp_path, host):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 256, 5000).astype(
        np.int32).tofile(path)
    t, j = _pair("dense", batch=4, seq_len=32, host_id=host, n_hosts=2,
                 source="memmap", path=str(path))
    for step in range(5):
        _assert_same(t.batch_at(step), j.batch_at(step))


def test_iteration_and_restart_from_state():
    """``next`` advances the stream; a pipeline restored from the state's
    dict (what the trainer checkpoints) continues with the same batch, as
    JAX's does."""
    t, j = _pair("dense", batch=2, seq_len=8, seed=1)
    for _ in range(3):
        _assert_same(next(t), next(j))
    saved = t.state.to_dict()
    assert saved == j.state.to_dict() == {"step": 3}
    fresh, _ = _pair("dense", batch=2, seq_len=8, seed=1)
    fresh.state = PipelineState.from_dict(saved)
    _assert_same(next(fresh), next(j))


def test_prefetch_never_drops_a_batch():
    """A queue of one and a slow consumer: every batch arrives, in order,
    each JAX's batch at its step."""
    t, j = _pair("dense", batch=2, seq_len=8, prefetch=1)
    t.start_prefetch()
    try:
        for step in range(6):
            time.sleep(0.02)
            _assert_same(t.get_prefetched(), j.batch_at(step))
    finally:
        t.stop()
    assert t._thread is None


def test_prefetch_reraises_the_workers_exception():
    t, _ = _pair("dense", batch=2, seq_len=8)

    def broken(step):
        raise ValueError("bad shard")

    t.batch_at = broken
    t.start_prefetch()
    try:
        with pytest.raises(RuntimeError, match="prefetch worker failed"
                           ) as info:
            t.get_prefetched(timeout=5.0)
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        t.stop()


def test_batch_must_divide_over_hosts():
    with pytest.raises(AssertionError):
        DataPipeline(get_reduced("qwen2.5-3b"), batch=3, seq_len=8,
                     n_hosts=2)
