"""Serving layer: continuous-batching servers and decode caches.

Two backends share the admission-queue / step-boundary batching design:

* LM decode — ``repro_torch.launch.serve`` (its ``main`` loop and ``Server``) over
  ``repro_torch.models.decode`` / ``repro_torch.models.prefill``;
* k-ANN — :mod:`repro_torch.serve.ann` (``AnnServer``, ``AsyncAnnServer``,
  the ``DegradationLadder``) over :class:`~repro_torch.core.suco.SuCoEngine`.

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
]
