"""Fault tolerance on the serving path: deterministic chaos injection
(``chaos``) and the restart policy that bounds each request's retries
(``failures``).  Elastic meshes and straggler detection are not ported
yet."""

from repro_torch.ft.chaos import SITES, ChaosInjector, SimulatedStepFailure
from repro_torch.ft.failures import (
    FailureInjector,
    RestartPolicy,
    SimulatedNodeFailure,
    run_with_restarts,
)

__all__ = [
    "SITES",
    "ChaosInjector",
    "FailureInjector",
    "RestartPolicy",
    "SimulatedNodeFailure",
    "SimulatedStepFailure",
    "run_with_restarts",
]
