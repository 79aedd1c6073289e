"""Failure handling: injection (for drills), detection, restart policy.

At 1000+ nodes, node loss is routine: the design here is the standard
checkpoint/restart loop hardened for it —

  detect (heartbeat timeout / device error)  ->  classify  ->  either
  (a) restart-in-place from the latest committed checkpoint, or
  (b) elastic shrink when capacity is lost (not ported yet).

This module is deliberately runnable on one CPU: ``FailureInjector``
deterministically raises ``SimulatedNodeFailure`` inside the step loop so
tests/drills exercise the same recovery path a real run would take.  The
serving engine holds one :class:`RestartPolicy` per request as its retry
budget (``ServeConfig.max_request_retries`` / ``retry_reset_steps``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.obs import clock


class SimulatedNodeFailure(RuntimeError):
    def __init__(self, node_id: int, step: int):
        super().__init__(f"node {node_id} failed at step {step}")
        self.node_id = node_id
        self.step = step


@dataclass
class FailureInjector:
    """Deterministic failure schedule: {step: node_id}."""

    schedule: dict = field(default_factory=dict)

    def check(self, step: int) -> None:
        if step in self.schedule:
            node = self.schedule.pop(step)
            raise SimulatedNodeFailure(node, step)


@dataclass
class RestartPolicy:
    """Bounded-retry restart with exponential backoff (capped).

    ``reset_after_steps`` makes the budget recover: if that many steps
    pass between failures, the restart counter resets to zero before
    the new failure is counted.  Without it a long-lived process (a
    serve engine handling weeks of traffic) would exhaust the budget
    from faults that are hours apart — the budget should bound failure
    *density*, not lifetime total.  0 disables the reset (the training
    loop's original accumulate-forever behavior).
    """

    max_restarts: int = 5
    backoff_s: float = 0.01
    backoff_cap_s: float = 1.0
    reset_after_steps: int = 0
    restarts: int = 0
    last_failure_step: int = -1

    def on_failure(self, exc: Exception, step: int) -> float:
        """Returns backoff seconds before restart; raises if budget spent."""
        if (self.reset_after_steps > 0 and self.last_failure_step >= 0
                and step - self.last_failure_step >= self.reset_after_steps):
            self.restarts = 0
        self.restarts += 1
        self.last_failure_step = step
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"restart budget exhausted after {self.restarts - 1} restarts"
            ) from exc
        return min(self.backoff_s * (2 ** (self.restarts - 1)),
                   self.backoff_cap_s)


def run_with_restarts(
    step_fn: Callable[[int], None],
    *,
    start_step: int,
    total_steps: int,
    restore_fn: Callable[[], int],
    policy: Optional[RestartPolicy] = None,
    injector: Optional[FailureInjector] = None,
) -> int:
    """Drive ``step_fn`` with checkpoint/restart semantics.

    ``restore_fn`` must rewind all mutable state (params/opt/data) to the
    latest committed checkpoint and return its step.  Returns the number of
    restarts performed.
    """
    policy = policy or RestartPolicy()
    step = start_step
    while step < total_steps:
        try:
            if injector is not None:
                injector.check(step)
            step_fn(step)
            step += 1
        except (SimulatedNodeFailure, RuntimeError) as exc:
            if isinstance(exc, RuntimeError) and not isinstance(
                exc, SimulatedNodeFailure
            ):
                raise
            delay = policy.on_failure(exc, step)
            clock.sleep(delay)
            step = restore_fn()
    return policy.restarts
