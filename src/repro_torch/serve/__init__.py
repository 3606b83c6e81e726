"""Simulation-as-a-service: continuous batching over slots (port of
`repro/serve`).

See serve/service.py for the architecture and DESIGN.md §14 for the bit for
bit heterogeneous-batching contract; docs/serve.md is the JAX package's
user guide, whose API this package keeps.
"""

from repro_torch.serve.batcher import BatcherError, SlotBatcher
from repro_torch.serve.service import SessionResult, SimulationService, SlotExtras
from repro_torch.serve.session import (
    EVICTED,
    FINISHED,
    QUEUED,
    RUNNING,
    Session,
    SessionRequest,
    TrafficGenerator,
)

__all__ = [
    "BatcherError",
    "SlotBatcher",
    "SessionResult",
    "SimulationService",
    "SlotExtras",
    "Session",
    "SessionRequest",
    "TrafficGenerator",
    "QUEUED",
    "RUNNING",
    "EVICTED",
    "FINISHED",
]
