"""Checkpoint lifecycle: rotation, async save, auto-resume."""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.tree import is_namedtuple


def _host_copy(tree):
    """Every leaf copied to host memory now (a tensor's ``.cpu()`` of a
    CPU tensor would be the same storage, so copies are explicit): a
    later in-place update of the live tree cannot reach the save."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(_host_copy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class CheckpointManager:
    """Rotating checkpoints with optional async (background-thread) save.

    An async save copies the tree to the host first, in the caller's
    thread (the JAX package's ``device_get``), and then compresses and
    writes it on a thread, so the step loop never waits on the disk.  A
    save that failed on its thread raises from the next :meth:`wait`.
    """

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 host_id: int = 0, n_hosts: int = 1):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None):
        snapshot = _host_copy(tree)

        def work():
            save_checkpoint(self.directory, step, snapshot,
                            host_id=self.host_id, n_hosts=self.n_hosts,
                            extra=extra)
            self._rotate()

        if not self.async_save:
            work()
            return

        def guarded():
            try:
                work()
            except Exception as e:  # re-raised by wait()
                self._error = e

        self.wait()
        self._pending = threading.Thread(target=guarded, daemon=True)
        self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template):
        """``(step, tree, extra)`` of the latest committed checkpoint, or
        ``(None, None, None)``."""
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        tree, extra = load_checkpoint(self.directory, template, step)
        return step, tree, extra

    def _rotate(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and ".tmp" not in n and
            os.path.exists(os.path.join(self.directory, n, "COMMITTED")))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
