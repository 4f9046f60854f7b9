"""Serving layer: continuous-batching servers and decode caches.

Two backends share the admission-queue / step-boundary batching design:

* LM decode — ``repro_torch.launch.serve`` (its ``main`` loop and ``Server``) over
  ``repro_torch.models.decode`` / ``repro_torch.models.prefill``;
* k-ANN — :mod:`repro_torch.serve.ann` (``AnnServer``, ``AsyncAnnServer``,
  the ``DegradationLadder``) over :class:`~repro_torch.core.suco.SuCoEngine`,
  made mutable by :mod:`repro_torch.serve.mutation` (``MutationManager``:
  keys, drift, the warm re-index, off the serving thread on a stream of its
  own), durable by :mod:`repro_torch.serve.durability` (WAL, snapshots,
  ``recover``) and drilled by :mod:`repro_torch.serve.chaos` (virtual clock,
  fault injection, crash points, ``recovery_drill``).

Both are re-exported here as the public serving API.
"""

from repro_torch.launch.serve import Request, Server
from repro_torch.models.decode import decode_step, init_cache
from repro_torch.models.prefill import prefill
from repro_torch.serve.ann import (
    AnnRequest,
    AnnServer,
    AsyncAnnServer,
    DegradationLadder,
    OverloadController,
    StepRecord,
    latency_summary,
)
from repro_torch.serve.chaos import (
    CRASH_POINTS,
    ChaosConfig,
    ChaosEngine,
    ChaosError,
    CrashInjector,
    CrashPoint,
    DrillReport,
    DrillStep,
    ReplayReport,
    VirtualClock,
    drill_steps,
    flood_trace,
    kill_pool_engine,
    recovery_drill,
    replay,
    wrap_ladder,
)
from repro_torch.serve.durability import (
    Durability,
    DurabilityConfig,
    RecoveryError,
    RecoveryReport,
    RecoveryResult,
    WalRecord,
    WriteAheadLog,
    load_serving_stack,
    recover,
    save_stack,
)
from repro_torch.serve.mutation import (
    DriftMonitor,
    DriftReport,
    MutationManager,
    ReindexInProgressError,
)

__all__ = [
    "Request",
    "Server",
    "decode_step",
    "init_cache",
    "prefill",
    "AnnRequest",
    "AnnServer",
    "AsyncAnnServer",
    "DegradationLadder",
    "OverloadController",
    "StepRecord",
    "latency_summary",
    "ChaosConfig",
    "ChaosEngine",
    "ChaosError",
    "ReplayReport",
    "VirtualClock",
    "flood_trace",
    "replay",
    "wrap_ladder",
    "CRASH_POINTS",
    "CrashInjector",
    "CrashPoint",
    "DrillReport",
    "DrillStep",
    "drill_steps",
    "recovery_drill",
    "kill_pool_engine",
    "Durability",
    "DurabilityConfig",
    "RecoveryError",
    "RecoveryReport",
    "RecoveryResult",
    "WalRecord",
    "WriteAheadLog",
    "load_serving_stack",
    "recover",
    "save_stack",
    "DriftMonitor",
    "DriftReport",
    "MutationManager",
    "ReindexInProgressError",
]
