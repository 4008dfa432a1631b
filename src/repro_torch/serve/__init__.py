"""repro_torch.serve — fault-tolerant async serving front-end; port of
``repro.serve``.

The production entry path in front of ``FleetRuntime``: many
concurrent clients submit per-device sample bursts, a dynamic batcher
closes constant-shape tick windows on max-batch-or-max-delay
deadlines, an admission controller applies backpressure (queue depth,
tick p99 SLO, the merge governor's comm budget) with explicit
shed-vs-defer outcomes and per-client fair-share caps, a degraded-mode
ladder (skip-merge → serve-stale-scores → shed) keeps the fleet
answering under overload, and a write-ahead log of closed windows
makes a SIGKILL recoverable: restore the newest snapshot, replay the
logged suffix on the same inputs, ack every admitted request exactly
once. Requests, windows and the log are numpy on the host; each tick's
batch reaches the runtime's device in ``FleetRuntime.tick``.

See ``benchmarks/torch_serve_ingress.py`` for the measured contract.
"""
from repro_torch.serve.admission import (
    ADMIT,
    DEFER,
    SHED,
    STALE,
    AdmissionConfig,
    AdmissionController,
)
from repro_torch.serve.batcher import TickWindow, WindowBuilder
from repro_torch.serve.degraded import DegradedLadder, LadderConfig, Mode
from repro_torch.serve.frontend import RetryConfig, ServeConfig, ServeFrontend
from repro_torch.serve.protocol import Ack, SampleRequest, request_id
from repro_torch.serve.wal import WriteAheadLog

__all__ = [
    "ADMIT", "DEFER", "SHED", "STALE",
    "AdmissionConfig", "AdmissionController",
    "TickWindow", "WindowBuilder",
    "DegradedLadder", "LadderConfig", "Mode",
    "RetryConfig", "ServeConfig", "ServeFrontend",
    "Ack", "SampleRequest", "request_id",
    "WriteAheadLog",
]
