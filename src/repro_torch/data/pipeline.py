"""Deterministic, shardable data pipeline, a numpy copy of the JAX
package's (``repro.data.pipeline``): for any (seed, step, host) it yields
the same numpy batches bit for bit.

Each host reads only its shard of the token stream (``host_id`` /
``n_hosts``), a background thread prefetches ahead of the step loop, and
the stream position is part of the checkpoint so restarts are bit-exact.
Sources: ``synthetic`` (a seeded token stream — used by every example and
test) and ``memmap`` (a binary int32 token file).

The pipeline yields the batch dict the model's ``forward`` expects per
family (tokens/labels ``(B, S)``, ``(B, S, K)`` for audio, plus
``img_embeds`` for vlm) as numpy arrays; the train step makes tensors of
them on its device.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.config.base import ModelConfig


@dataclass
class PipelineState:
    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))


class DataPipeline:
    def __init__(
        self,
        cfg: ModelConfig,
        batch: int,
        seq_len: int,
        seed: int = 0,
        host_id: int = 0,
        n_hosts: int = 1,
        source: str = "synthetic",
        path: Optional[str] = None,
        prefetch: int = 2,
    ):
        assert batch % n_hosts == 0, (batch, n_hosts)
        self.cfg = cfg
        self.batch = batch // n_hosts      # per-host batch
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.state = PipelineState()
        self._data = None
        if source == "memmap":
            assert path is not None
            self._data = np.memmap(path, dtype=np.int32, mode="r")
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None

    # ------------------------------------------------------------- batches
    def _tokens_for_step(self, step: int) -> np.ndarray:
        """Deterministic tokens for (step, host): restart-safe."""
        n = self.batch * (self.seq_len + 1)
        if self._data is not None:
            start = (step * self.n_hosts + self.host_id) * n % max(
                1, len(self._data) - n
            )
            flat = np.asarray(self._data[start : start + n])
        else:
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 4096 + self.host_id
            )
            flat = rng.integers(
                0, self.cfg.vocab_size, size=n, dtype=np.int32
            )
        return flat.reshape(self.batch, self.seq_len + 1)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        toks = self._tokens_for_step(step)
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }
        if self.cfg.family == "audio":
            k = self.cfg.n_codebooks
            rng = np.random.default_rng(self.seed * 7 + step)
            full = rng.integers(
                0, self.cfg.vocab_size,
                size=(self.batch, self.seq_len + 1, k), dtype=np.int32)
            batch["tokens"], batch["labels"] = full[:, :-1], full[:, 1:]
        elif self.cfg.family == "vlm":
            rng = np.random.default_rng(self.seed * 13 + step)
            batch["img_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.img_tokens, self.cfg.d_model)
            ).astype(np.float32)
        return batch

    # ------------------------------------------------------------ iterator
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    # ----------------------------------------------------------- prefetch
    def start_prefetch(self):
        if self._thread is not None:
            return
        self._exc = None

        def worker():
            try:
                while not self._stop.is_set():
                    # generate exactly once, then retry the *same* batch
                    # while the queue is full — putting next(self) inside
                    # the retry would advance the step counter and drop
                    # the batch on every Full, silently skipping data
                    b = next(self)
                    while not self._stop.is_set():
                        try:
                            self._q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surfaces via get_prefetched
                self._exc = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def get_prefetched(self, timeout: float = 10.0):
        """Next prefetched batch; re-raises anything the worker died on
        (a dead worker would otherwise present as an eternal Empty)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self._q.get(timeout=0.05)
            except queue.Empty:
                if self._exc is not None:
                    raise RuntimeError(
                        "prefetch worker failed") from self._exc
                if time.monotonic() >= deadline:
                    raise

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None


def synthetic_batch_specs(cfg: ModelConfig, batch: int, seq_len: int,
                          device="meta") -> Dict[str, torch.Tensor]:
    """Empty tensors with the keys, shapes and dtypes of a batch of
    :meth:`DataPipeline.batch_at` (the dry run's input specs; on ``meta``
    they take no memory)."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    tok = ((batch, seq_len, cfg.n_codebooks) if cfg.family == "audio"
           else (batch, seq_len))
    specs = {"tokens": spec(tok, torch.int32),
             "labels": spec(tok, torch.int32)}
    if cfg.family == "vlm":
        specs["img_embeds"] = spec((batch, cfg.img_tokens, cfg.d_model),
                                   torch.float32)
    return specs
