"""Named spans around the port's chunk loops.

Each step of a chunk loop (the streaming and fused queries' chunks, the
sharded query's blocks, the Lloyd steps of a K-means training) runs inside
``loop_span(name)``: while an op recorder is open or the profiler runs, a
``torch.profiler.record_function`` span named ``loop:<name>``.  A profile
names the steps by it, and an op trace (:mod:`repro_torch.analysis.
trace_rules`) sees the span open and close, so it knows which ops run once
a step: the scope of the ``no-scatter-in-scan`` rule, as a ``scan`` body is
in the JAX package.  Otherwise, as when serving, a span is a null context
and issues no dispatcher call.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["LOOP_PREFIX", "loop_span", "recording"]

LOOP_PREFIX = "loop:"
_recorders = 0  # op recorders open


@contextlib.contextmanager
def recording():
    """Open loop spans while in this context (an op recorder's lifetime)."""
    global _recorders
    _recorders += 1
    try:
        yield
    finally:
        _recorders -= 1


def loop_span(name: str) -> contextlib.AbstractContextManager:
    """The span of one step of the loop ``name``."""
    if _recorders or torch.autograd._profiler_enabled():
        return torch.profiler.record_function(LOOP_PREFIX + name)
    return contextlib.nullcontext()
