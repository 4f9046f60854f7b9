"""Large-scale resilience utilities: straggler detection, failure-driven
restart, elastic re-sharding (a copy of the JAX package's pure-Python
``repro.train.resilience``; :class:`StepTimer` also takes its clock, so a
test can drive it).

On thousands of nodes the dominant failure modes are (a) whole-job restart
after a hardware fault (handled by checkpoint+resume in launch/train.py),
(b) slow hosts dragging the synchronous step (detected here), (c) planned
re-scaling (handled by sharding-agnostic checkpoints, see train.checkpoint).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

__all__ = ["StepTimer", "FailureInjector", "run_with_restarts"]


@dataclasses.dataclass
class StepTimer:
    """EWMA step timer; flags stragglers at ``threshold`` x the running mean.

    On a real cluster the flagged step would page the straggler-mitigation
    policy (evict host / shrink mesh); here it feeds metrics + tests.
    """

    alpha: float = 0.1
    threshold: float = 2.0
    ewma: float | None = None
    flagged: int = 0
    _t0: float | None = None
    clock: Callable[[], float] = time.perf_counter

    def start(self) -> None:
        self._t0 = self.clock()

    def stop(self) -> float:
        dt = self.clock() - self._t0
        is_straggler = self.ewma is not None and dt > self.threshold * self.ewma
        if is_straggler:
            self.flagged += 1
        # stragglers don't poison the mean
        if self.ewma is None:
            self.ewma = dt
        elif not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return dt

    def is_straggler(self, dt: float) -> bool:
        return self.ewma is not None and dt > self.threshold * self.ewma


class FailureInjector:
    """Deterministic fault injection for restart tests: raises on the
    configured steps (once each)."""

    def __init__(self, fail_at: tuple[int, ...] = ()):  # global step numbers
        self.fail_at = set(fail_at)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.remove(step)
            raise RuntimeError(f"injected node failure at step {step}")


def run_with_restarts(
    train_once: Callable[[], int],
    *,
    max_restarts: int = 3,
) -> int:
    """Run ``train_once`` (which resumes from the latest checkpoint) until it
    completes, restarting on failure up to ``max_restarts`` times.  Returns
    the number of restarts that occurred."""
    restarts = 0
    while True:
        try:
            train_once()
            return restarts
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
