"""Fault tolerance: deterministic chaos injection on the serving path
(``chaos``), the restart policy that bounds each request's retries and
the training loop's checkpoint/restart drill (``failures``), and straggler
detection (``straggler``), and the elastic shrink of a mesh on node loss
(``elastic``)."""

from repro_torch.ft.chaos import SITES, ChaosInjector, SimulatedStepFailure
from repro_torch.ft.elastic import ElasticMeshManager, ElasticPlan
from repro_torch.ft.failures import (
    FailureInjector,
    RestartPolicy,
    SimulatedNodeFailure,
    run_with_restarts,
)
from repro_torch.ft.straggler import StragglerEvent, StragglerMonitor

__all__ = [
    "SITES",
    "ChaosInjector",
    "ElasticMeshManager",
    "ElasticPlan",
    "FailureInjector",
    "RestartPolicy",
    "SimulatedNodeFailure",
    "SimulatedStepFailure",
    "StragglerEvent",
    "StragglerMonitor",
    "run_with_restarts",
]
