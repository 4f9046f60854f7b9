"""Continuous micro-batching ANN server over a :class:`~repro_torch.core.suco.SuCoEngine`.

The counterpart of the JAX package's ``repro.serve.ann``, class for class.
Heterogeneous ``(query, k)`` requests enter an admission queue; at every
step boundary the scheduler forms one micro-batch of same-``k`` requests
(mixed-k traffic resolves into alternating steps), the engine pads the
batch to a policy bucket (:func:`repro_torch.core.suco.batch_bucket`) and
answers it.  Per-request latency is accounted from admission to result
materialisation on the host, and every step records the engine's
``compile_count`` ((bucket, k) pairs warmed or served): flat after warm-up
is the serving invariant.

Two step disciplines over the same admission queue:

* :class:`AnnServer` — synchronous: each step dispatches one micro-batch
  and copies its results to the host before the next admission.
* :class:`AsyncAnnServer` — pipelined: dispatch is decoupled from result
  delivery through a bounded in-flight window (``depth``).  CUDA launches
  return before the card finishes, so a dispatched batch's results are
  copied to the host only when the window is full or the queue drains.
  The fused query reads one overflow flag back per chunk
  (``EngineStats.host_syncs``), so in that mode a dispatch blocks for most
  of its batch and the window overlaps little; the dense and streaming
  modes read nothing back.  Every launch stays on the current stream, so
  an ``insert`` / ``delete`` between steps is ordered after the in-flight
  queries that read ``x``.  Per-request latency splits into queueing
  (admission -> dispatch) and execution (dispatch -> materialisation).

Resilience layer (both servers):

* **Deadlines** — ``AnnRequest.deadline_s`` is a relative latency budget
  fixed into an absolute ``t_deadline`` at admission.  Batches form
  oldest-deadline-first (FIFO among deadline ties and deadline-free
  requests), and requests whose deadline precedes ``now`` plus the recent
  execution-latency estimate are expired at dispatch time instead of
  burning a batch slot.
* **Admission control** — ``max_queue`` bounds the admission queue;
  requests beyond it are shed at ``submit`` with an explicit error.
* **Degraded mode** — an :class:`OverloadController` watches queue depth
  and head-of-queue wait and steps the server along a
  :class:`DegradationLadder` of warmed engines with reduced
  (alpha, beta, survivor_cap) budgets
  (:meth:`~repro_torch.core.suco.EnginePolicy.degraded`).  Every answer
  served through a ladder carries the Theorem-2 floor recomputed for its
  level's budget (:func:`repro_torch.core.theory.degraded_budget_bound`) on
  ``AnnRequest.quality_bound``: degraded answers are quantified, never
  silent.
* **Fault isolation** — a dispatch failure other than ``ValueError`` is
  retried once after a jittered backoff; if the batch still fails, each
  request is served alone so one poison query fails only its own request.

The results reach the host only at the sync step, at ``_retire`` and in
``_isolate``; those lines carry a ``# host-sync: ok`` comment, which
``tests/test_torch_serve.py`` requires of every host copy in this package.

On the card:
  PYTHONPATH=src python -m repro_torch.serve.ann --n 200000 --d 128 --requests 256
On the CPU:
  PYTHONPATH=src python -m repro_torch.serve.ann --device cpu --n 20000 --d 32 --requests 64
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import theory
from repro_torch.core.sc_linear import QueryResult
from repro_torch.core.suco import EnginePolicy, SuCoConfig, SuCoEngine, batch_bucket

__all__ = [
    "AnnRequest",
    "StepRecord",
    "OverloadController",
    "DegradationLadder",
    "AnnServer",
    "AsyncAnnServer",
    "latency_summary",
]


@dataclasses.dataclass
class AnnRequest:
    """One k-ANN request: a single query vector and its own ``k``."""

    rid: int
    query: np.ndarray  # (d,)
    k: int
    deadline_s: float | None = None  # relative latency budget (None = none)
    t_submit: float = 0.0  # admission-queue entry
    t_start: float = 0.0  # micro-batch dispatch
    t_done: float = 0.0  # results materialised on host (or rejection time)
    t_deadline: float = math.inf  # absolute deadline, fixed at admission
    ids: np.ndarray | None = None  # (k,) int32
    dists: np.ndarray | None = None  # (k,)
    error: str | None = None  # rejection reason (bad input / shed / expired)
    shed: bool = False  # rejected at admission (queue full)
    expired: bool = False  # deadline passed before dispatch
    degrade_level: int = 0  # ladder level the answer was served at
    quality_bound: float | None = None  # Theorem-2 floor for that level
    retries: int = 0  # transient-dispatch-error retries spent

    @property
    def done(self) -> bool:
        return self.ids is not None

    @property
    def finished(self) -> bool:
        """Answered or terminally rejected (error / shed / expired)."""
        return self.ids is not None or self.error is not None

    @property
    def hit_deadline(self) -> bool:
        """Answered within the deadline (vacuously true without one)."""
        return self.done and self.t_done <= self.t_deadline

    @property
    def latency_s(self) -> float:
        """Admission-to-result latency (queueing + padding + execution)."""
        return self.t_done - self.t_submit

    @property
    def queue_s(self) -> float:
        """Queueing latency: admission to micro-batch dispatch."""
        return self.t_start - self.t_submit

    @property
    def exec_s(self) -> float:
        """Execution latency: dispatch to host-side materialisation (for
        the pipelined server this includes time spent waiting behind other
        in-flight batches on the device stream)."""
        return self.t_done - self.t_start


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """Per-step accounting: what ran and whether the engine met a new
    (bucket, k) pair."""

    n_requests: int
    k: int
    bucket: int
    step_s: float  # dispatch -> results materialised on host
    compile_count: int  # (bucket, k) pairs after this step (ladder-wide total)
    dispatch_s: float = 0.0  # host time to form/pad/enqueue the batch
    # (the synchronous server folds dispatch into step_s and leaves this 0)
    level: int = 0  # degradation-ladder level the step was served at


@dataclasses.dataclass
class OverloadController:
    """Hysteretic overload detector driving the degradation ladder.

    Consumes the two load signals the servers already account — admission
    queue depth and head-of-queue wait (the queueing half of the
    queue/exec latency split) — and maintains a degradation ``level``:

    * **step up** after ``patience`` consecutive overloaded observations
      (depth >= ``high_depth`` or head wait >= ``high_wait_s``);
    * **step down** after ``cooldown`` consecutive calm observations
      (depth <= ``low_depth`` and head wait < ``high_wait_s / 2``).

    The two-sided hysteresis keeps the ladder from flapping at the
    boundary; levels clamp to ``[0, max_level]``.  Deterministic: the
    level is a pure function of the observation sequence.
    """

    max_level: int = 2
    high_depth: int = 32
    low_depth: int = 4
    high_wait_s: float = 0.05
    patience: int = 2
    cooldown: int = 2
    level: int = dataclasses.field(default=0, init=False)
    _hot: int = dataclasses.field(default=0, init=False, repr=False)
    _calm: int = dataclasses.field(default=0, init=False, repr=False)

    def update(self, depth: int, head_wait_s: float) -> int:
        """Feed one (queue depth, head-of-queue wait) observation; returns
        the level the next batch should be served at."""
        overloaded = depth >= self.high_depth or head_wait_s >= self.high_wait_s
        calm = depth <= self.low_depth and head_wait_s < self.high_wait_s / 2
        if overloaded:
            self._hot, self._calm = self._hot + 1, 0
        elif calm:
            self._hot, self._calm = 0, self._calm + 1
        else:
            self._hot = self._calm = 0
        if self._hot >= self.patience and self.level < self.max_level:
            self.level += 1
            self._hot = 0
        elif self._calm >= self.cooldown and self.level > 0:
            self.level -= 1
            self._calm = 0
        return self.level


class _HostRows:
    """Rows of an engine's ``x`` by index, as host arrays: what
    :func:`~repro_torch.core.theory.estimate_subspace_statistics` reads of
    its ``x``, so it draws the JAX package's sample (empty slots of a
    mutable engine included) while only the sampled rows leave the device."""

    def __init__(self, engine: SuCoEngine):
        self.shape = tuple(engine.x.shape)
        self._engine = engine

    def __getitem__(self, ids) -> np.ndarray:
        return self._engine.host_rows(ids)


class DegradationLadder:
    """Warmed engines over one ``(x, index)`` at stepped-down budgets.

    Level 0 is the base engine; level ``l`` serves
    ``engine.policy.degraded(l)`` — reduced (alpha, beta, survivor_cap) —
    on the base engine's device and tensors (no copy of ``x`` a level).
    Every level's recall floor is Theorem 2 recomputed for its budget
    (:func:`repro_torch.core.theory.degraded_budget_bound`) from sampled
    subspace statistics
    (:func:`repro_torch.core.theory.estimate_subspace_statistics`, over the
    sampled rows alone, copied to the host once), so an answer served
    degraded carries a *quantified* guarantee.

    Reported floors are monotonised down the ladder
    (``bound(l) = min over levels <= l``): each level's bound is a valid
    lower bound for its own budget, and reporting the minimum keeps the
    ladder honest where the raw Theorem-2 term is not monotone in alpha
    (shrinking alpha widens the collision radius) — a server must never
    claim *more* recall because it is shedding work.

    :meth:`warmup` warms every level's ``(bucket, k)`` pairs so stepping
    the ladder under load meets no new pair; ``compile_count`` sums the
    whole ladder for the zero-retrace invariant.
    """

    def __init__(
        self,
        engine: SuCoEngine,
        levels: int = 2,
        *,
        stats: tuple[float, float] | None = None,
        stats_seed: int = 0,
    ):
        if levels < 0:
            raise ValueError(f"ladder levels must be >= 0, got {levels}")
        self.engines: list[SuCoEngine] = [engine]
        for lv in range(1, levels + 1):
            self.engines.append(
                SuCoEngine(engine.x, engine.index, engine.policy.degraded(lv),
                           device=engine.device)
            )
        if stats is None:
            stats = theory.estimate_subspace_statistics(
                _HostRows(engine), engine.index.spec.n_subspaces, seed=stats_seed,
            )
        self.m_stat, self.sigma_stat = float(stats[0]), float(stats[1])
        self._bounds: dict[tuple[int, int, int], float] = {}

    @property
    def max_level(self) -> int:
        return len(self.engines) - 1

    def engine_for(self, level: int) -> SuCoEngine:
        """The engine serving ``level`` (clamped to the ladder)."""
        return self.engines[min(max(level, 0), self.max_level)]

    def rebind(self) -> None:
        """Propagate the base engine's live ``(x, index)`` to every sibling.

        Levels 1+ were constructed over level 0's arrays; after an in-place
        mutation on the base (insert / delete) they must be re-pointed at
        the mutated arrays or degraded answers would be served from the
        pre-mutation corpus — including already-tombstoned ids.  Shapes are
        unchanged, so the siblings' warmed (bucket, k) pairs still hold.
        """
        base = self.engines[0]
        for sib in self.engines[1:]:
            sib._rebind(
                base.x, base.index,
                n_live=base.n_live, next_slot=base._next_slot,
            )

    def quality_bound(self, level: int, k: int) -> float:
        """The monotonised Theorem-2 success floor at ``(level, k)``.

        Computed against the *live* point count, not the build-time one:
        inserts and tombstoned deletes move ``n``, and a floor quoted for
        a corpus size that no longer exists is not a guarantee.  The cache
        key carries ``n`` so mutation invalidates stale entries for free.
        """
        level = min(max(level, 0), self.max_level)
        base = self.engines[0]
        n = int(base.n_live)
        key = (level, k, n)
        if key not in self._bounds:
            ns = base.index.spec.n_subspaces
            self._bounds[key] = min(
                theory.degraded_budget_bound(
                    n, k, ns, self.m_stat, self.sigma_stat,
                    e.policy.alpha, e.policy.beta,
                )
                for e in self.engines[: level + 1]
            )
        return self._bounds[key]

    def warmup(
        self,
        batch_sizes: Sequence[int] | None = (1,),
        ks: Sequence[int] = (10,),
    ) -> int:
        """Warm every level's (bucket, k) pairs; returns the new ones."""
        return sum(e.warmup(batch_sizes, ks) for e in self.engines)

    @property
    def compile_count(self) -> int:
        """Ladder-wide (bucket, k) count (the zero-retrace accounting unit)."""
        return sum(e.compile_count for e in self.engines)


class AnnServer:
    """Continuous micro-batching over a warmed :class:`SuCoEngine`.

    Mirrors :class:`repro.launch.serve.Server`'s slot design: ``max_batch``
    is the slot count, the queue refills the batch at each step boundary.
    Requests with different ``k`` cannot share a batch, so a step
    serves the ``k`` of the most urgent request (oldest deadline, FIFO on
    ties) and defers the rest — arrival order is preserved within every
    ``k`` class and across deferrals, and with no deadlines in play the
    schedule is exactly FIFO-first-``k``.

    Resilience knobs (all optional; the defaults are the pre-resilience
    behavior):

    * ``max_queue`` — bounded admission: ``submit`` beyond it sheds the
      request (completes-with-error, ``shed=True``) instead of queueing.
    * ``ladder`` + ``controller`` — overload-driven degraded mode; see
      :class:`DegradationLadder` / :class:`OverloadController`.  With a
      ladder but no controller the level is pinned at ``self.level``
      (settable — the forced degrade/recover cycle the benchmarks drive).
    * ``max_retries`` / ``backoff_s`` — transient dispatch errors are
      retried with jittered backoff before falling back to per-request
      isolation.  ``sleep`` is injectable so fault-injection replays
      (``serve/chaos.py``) stay on a virtual clock.
    """

    def __init__(
        self,
        engine: SuCoEngine,
        max_batch: int = 64,
        clock: Callable[[], float] = time.perf_counter,
        *,
        max_queue: int | None = None,
        ladder: DegradationLadder | None = None,
        controller: OverloadController | None = None,
        max_retries: int = 1,
        backoff_s: float = 0.002,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        durability=None,
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.clock = clock
        # A repro.serve.durability.Durability (or None): when set, every
        # acknowledged mutation is WAL-logged before the call returns.
        self.durability = durability
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.ladder = ladder
        self.controller = controller
        if controller is not None and ladder is not None:
            controller.max_level = min(controller.max_level, ladder.max_level)
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.sleep = sleep
        self.level = 0  # current ladder level (pinned when controller is None)
        self._rng = np.random.default_rng(seed)  # backoff jitter only
        self.queue: deque[AnnRequest] = deque()
        self.completed: list[AnnRequest] = []
        self.steps: list[StepRecord] = []

    # ---- admission -------------------------------------------------------

    def _validate(self, req: AnnRequest) -> str | None:
        """Admission-time validation: reject malformed requests here, with a
        per-request error, instead of failing a whole batch at dispatch."""
        d = self.engine.index.spec.d
        # k is bounded by the LIVE point count: tombstoned slots can never
        # appear in an answer, so admitting k > n_live would promise more
        # distinct neighbours than exist.
        n = int(getattr(self.engine, "n_live", self.engine.x.shape[0]))
        q = np.asarray(req.query)
        if q.ndim != 1 or q.shape[0] != d or not np.issubdtype(q.dtype, np.number):
            return f"query must be ({d},), got shape {q.shape} dtype {q.dtype}"
        if not np.isfinite(q).all():
            return "query contains NaN/Inf"
        if not 1 <= int(req.k) <= n:
            return f"k={req.k} must be in [1, n={n}]"
        return None

    def submit(self, req: AnnRequest) -> bool:
        """Admit one request; returns False if it was rejected (malformed
        input or admission queue full), in which case it is already in
        ``completed`` with ``error`` set."""
        now = self.clock()
        req.t_submit = now
        if req.deadline_s is not None:
            req.t_deadline = now + req.deadline_s
        err = self._validate(req)
        if err is not None:
            req.error, req.t_done = err, now
            self.completed.append(req)
            return False
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.shed = True
            req.error = f"shed: admission queue full (max_queue={self.max_queue})"
            req.t_done = now
            self.completed.append(req)
            return False
        self.queue.append(req)
        return True

    def submit_many(self, reqs: Sequence[AnnRequest]) -> int:
        """Admit a request sequence; returns how many were accepted."""
        return sum(self.submit(r) for r in reqs)

    # ---- scheduling ------------------------------------------------------

    def _est_exec_s(self) -> float:
        """Recent execution-latency estimate (median of the last few steps'
        exec time) — the feasibility signal for deadline expiry.  0.0 with
        no history, so expiry starts vacuous and tightens as steps land."""
        recent = [s.step_s for s in self.steps[-8:] if s.n_requests > 0]
        return float(np.median(recent)) if recent else 0.0

    def _expire_overdue(self, now: float) -> int:
        """Expire queued requests that cannot finish in time: their deadline
        precedes ``now`` plus the execution estimate.  Expired requests
        complete-with-error (``expired=True``) without burning a slot."""
        if not any(r.t_deadline < math.inf for r in self.queue):
            return 0
        horizon = now + self._est_exec_s()
        live: deque[AnnRequest] = deque()
        n_expired = 0
        for r in self.queue:
            if r.t_deadline < horizon:
                r.expired = True
                r.error = (
                    f"expired: deadline t={r.t_deadline:.6f} unreachable at "
                    f"dispatch (now={now:.6f})"
                )
                r.t_done = now
                self.completed.append(r)
                n_expired += 1
            else:
                live.append(r)
        self.queue = live
        return n_expired

    def _form_batch(self) -> tuple[list[AnnRequest], int]:
        """Pop the next same-``k`` micro-batch off the admission queue,
        oldest-deadline-first.

        The most urgent request (smallest ``t_deadline``, queue rank on
        ties — so deadline-free traffic stays FIFO) leads and fixes the
        batch's ``k``; other-``k`` requests keep their queue rank for a
        later step.
        """
        order = sorted(
            range(len(self.queue)), key=lambda i: (self.queue[i].t_deadline, i)
        )
        k = self.queue[order[0]].k
        taken: set[int] = set()
        batch: list[AnnRequest] = []
        for i in order:
            if len(batch) >= self.max_batch:
                break
            if self.queue[i].k == k:
                batch.append(self.queue[i])
                taken.add(i)
        self.queue = deque(r for i, r in enumerate(self.queue) if i not in taken)
        return batch, k

    def _serving_level(self, now: float) -> int:
        """The ladder level for the next batch: controller-driven when one
        is installed, else the pinned ``self.level``."""
        if self.controller is not None:
            head_wait = now - min((r.t_submit for r in self.queue), default=now)
            self.level = self.controller.update(len(self.queue), head_wait)
        if self.ladder is not None:
            self.level = min(self.level, self.ladder.max_level)
        elif self.level != 0:
            self.level = 0  # no ladder: nothing to degrade to
        return self.level

    def _engine_for(self, level: int) -> SuCoEngine:
        return self.ladder.engine_for(level) if self.ladder is not None else self.engine

    def _quality_bound(self, level: int, k: int) -> float | None:
        return self.ladder.quality_bound(level, k) if self.ladder is not None else None

    @property
    def executables(self) -> int:
        """(bucket, k) pairs across the whole serving surface (every ladder
        level when one is installed) — the quantity that must stay flat
        after warmup for the zero-retrace invariant."""
        return (
            self.ladder.compile_count
            if self.ladder is not None
            else self.engine.compile_count
        )

    # ---- live mutation ---------------------------------------------------

    def insert(self, x_new, *, keys=None) -> np.ndarray:
        """Insert points into the serving engine between steps; returns the
        assigned slot ids.  Ladder siblings are re-pointed at the mutated
        arrays so degraded answers see the same live corpus.  With a
        durability root attached the insert is WAL-logged (with its
        external ``keys``, if the caller tracks any) before the return —
        the acknowledgement implies the record is framed on disk."""
        slots = self.engine.insert(x_new)
        if self.ladder is not None:
            self.ladder.rebind()
        if self.durability is not None:
            self.durability.log_insert(x_new, slots, keys=keys)
        return slots

    def delete(self, ids) -> int:
        """Tombstone ids in the serving engine between steps; returns how
        many were newly deleted.  From the next dispatched batch on, no
        answer — base or degraded — can contain a tombstoned id."""
        n_newly = self.engine.delete(ids)
        if self.ladder is not None:
            self.ladder.rebind()
        if self.durability is not None:
            self.durability.log_delete(ids)
        return n_newly

    def swap(self, engine: SuCoEngine, *, ladder: DegradationLadder | None = None) -> None:
        """Hand the whole serving surface over to a warmed successor.

        ``engine`` replaces the base engine via :meth:`SuCoEngine.swap`
        (in-place adoption — object identity is preserved, so everything
        holding ``self.engine`` cuts over atomically).  When a degradation
        ladder is installed a successor ``ladder`` built over ``engine``
        must be supplied, warmed level-for-level; every level's warm
        contract is checked *before* any level is mutated, so a failed
        swap leaves the server fully on the old surface.  Queued requests
        are untouched — the next ``step`` dispatches on the successor.
        """
        if self.ladder is not None:
            if ladder is None:
                raise ValueError(
                    "server has a degradation ladder installed — pass a "
                    "warmed successor ladder built over the new engine"
                )
            if ladder.engines[0] is not engine:
                raise ValueError(
                    "successor ladder must be built over the successor "
                    "engine (ladder.engines[0] is not the engine passed)"
                )
            if len(ladder.engines) != len(self.ladder.engines):
                raise ValueError(
                    f"successor ladder has {len(ladder.engines)} levels, "
                    f"serving ladder has {len(self.ladder.engines)} — swap "
                    "level-for-level or rebuild the server"
                )
            pairs = list(zip(self.ladder.engines, ladder.engines))
        else:
            pairs = [(self.engine, engine)]
        # Check every level's warm contract before mutating any: a swap is
        # all-or-nothing across the ladder.
        for lv, (old, new) in enumerate(pairs):
            missing = old._buckets_seen - new._buckets_seen
            if missing:
                raise ValueError(
                    f"swap target level {lv} is not warmed over the live "
                    f"traffic mix — missing (bucket, k) pairs "
                    f"{sorted(missing)}; warm the successor first"
                )
        for old, new in pairs:
            old.swap(new)
        if self.ladder is not None:
            self.ladder.m_stat = ladder.m_stat
            self.ladder.sigma_stat = ladder.sigma_stat
            self.ladder._bounds = {}
        if self.durability is not None:
            # A bare swap installs state the WAL cannot replay; the
            # durability layer checkpoints it (suppressed when the swap is
            # part of a manager-driven, WAL-replayable reindex).
            self.durability.note_swap()

    # ---- fault isolation -------------------------------------------------

    def _query_with_retry(self, engine: SuCoEngine, batch, q, k: int):
        """One batch dispatch, retried ``max_retries`` times with jittered
        backoff on transient (non-ValueError) failures."""
        attempts = self.max_retries + 1
        for attempt in range(attempts):
            try:
                return engine.query(q, k=k)
            except ValueError:
                raise  # malformed input: retrying cannot help
            except Exception:
                if attempt + 1 >= attempts:
                    raise
                for r in batch:
                    r.retries += 1
                self.sleep(self.backoff_s * (0.5 + self._rng.random()))

    def _isolate(self, engine: SuCoEngine, batch, k: int, level: int) -> None:
        """Per-request fallback after a batch dispatch failed its retries:
        serve each request individually so one poison query fails alone."""
        qb = self._quality_bound(level, k)
        for r in batch:
            try:
                q1 = np.asarray(r.query)
                res = engine.query(q1, k=k)
                r.ids = res.ids.cpu().numpy()  # host-sync: ok — failure-isolation path
                r.dists = res.dists.cpu().numpy()  # host-sync: ok — failure-isolation path
                r.degrade_level, r.quality_bound = level, qb
            except Exception as e:
                r.error = f"{type(e).__name__}: {e}"
            r.t_done = self.clock()

    # ---- step loop -------------------------------------------------------

    def step(self) -> list[AnnRequest]:
        """Run one micro-batch; returns the requests it completed."""
        now = self.clock()
        self._expire_overdue(now)
        if not self.queue:
            return []
        level = self._serving_level(now)
        engine = self._engine_for(level)
        batch, k = self._form_batch()

        t0 = self.clock()
        for r in batch:
            r.t_start = t0
        qs = [np.asarray(r.query) for r in batch]
        try:
            res = self._query_with_retry(engine, batch, np.stack(qs), k)
            ids = res.ids.cpu().numpy()  # host-sync: ok — the sync serving step
            dists = res.dists.cpu().numpy()  # host-sync: ok — the sync serving step
            t1 = self.clock()
            qb = self._quality_bound(level, k)
            for i, r in enumerate(batch):
                r.ids, r.dists, r.t_done = ids[i], dists[i], t1
                r.degrade_level, r.quality_bound = level, qb
        except ValueError as e:
            # A malformed batch (should be impossible past submit-time
            # validation) completes-with-error without sinking the server.
            t1 = self.clock()
            for r in batch:
                r.error, r.t_done = str(e), t1
        except Exception:
            # Retries exhausted: isolate per request.
            self._isolate(engine, batch, k, level)
            t1 = self.clock()
        self.completed.extend(batch)
        self.steps.append(
            StepRecord(
                n_requests=len(batch),
                k=k,
                bucket=batch_bucket(len(batch), engine.policy.batch_buckets),
                step_s=t1 - t0,
                compile_count=self.executables,
                level=level,
            )
        )
        return batch

    def run_until_drained(self) -> list[AnnRequest]:
        while self.queue:
            self.step()
        return self.completed


@dataclasses.dataclass
class _Inflight:
    """A dispatched-but-unmaterialised micro-batch riding the device stream."""

    batch: list[AnnRequest]
    k: int
    result: QueryResult
    t_dispatch: float
    dispatch_s: float
    level: int = 0


class AsyncAnnServer(AnnServer):
    """Pipelined continuous micro-batching: dispatch overlaps execution.

    The double-buffered step loop the synchronous server cannot express:
    ``step`` forms, pads and *enqueues* the next micro-batch — CUDA
    launches return before the card finishes — and results are copied to
    the host (``_retire``, the one blocking point of this server) only once
    ``depth`` micro-batches are in flight or the queue drains.  With the
    default ``depth=2`` the host can assemble batch t+1 while batch t
    executes.  The fused query itself reads one overflow flag back per
    chunk, so in that mode ``_dispatch`` returns only near the end of its
    batch and little is left to overlap.

    Completion order equals dispatch order (the in-flight window is a
    FIFO), so results are a permutation of the synchronous server's only
    across the interleaving of ``k`` classes — per request the answer is
    identical.  Malformed requests are rejected at ``submit``; a dispatch
    that still fails is retried with backoff and then isolated per
    request, without touching the healthy batches already in flight, and
    a batch whose *materialisation* fails completes-with-error alone.
    Deadlines, admission control, and the degradation ladder behave as in
    :class:`AnnServer` (the level is sampled at dispatch and rides the
    in-flight record).
    """

    def __init__(
        self,
        engine: SuCoEngine,
        max_batch: int = 64,
        clock: Callable[[], float] = time.perf_counter,
        *,
        depth: int = 2,
        **resilience,
    ):
        super().__init__(engine, max_batch, clock, **resilience)
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = depth
        self._inflight: deque[_Inflight] = deque()

    @property
    def inflight(self) -> int:
        """Micro-batches dispatched but not yet materialised."""
        return len(self._inflight)

    def _dispatch(self) -> None:
        """Form the next micro-batch and enqueue it on the device (blocking
        only where the engine's query synchronises)."""
        now = self.clock()
        level = self._serving_level(now)
        engine = self._engine_for(level)
        batch, k = self._form_batch()
        t0 = self.clock()
        for r in batch:
            r.t_start = t0
        qs = [np.asarray(r.query) for r in batch]
        try:
            res = self._query_with_retry(engine, batch, np.stack(qs), k)
        except ValueError as e:
            # Validation failures surface here, before anything reaches the
            # device: the malformed micro-batch completes-with-error and the
            # in-flight healthy batches are untouched.
            t1 = self.clock()
            for r in batch:
                r.error, r.t_done = str(e), t1
            self.completed.extend(batch)
            self.steps.append(
                StepRecord(
                    n_requests=len(batch),
                    k=k,
                    bucket=batch_bucket(len(batch), engine.policy.batch_buckets),
                    step_s=t1 - t0,
                    compile_count=self.executables,
                    dispatch_s=t1 - t0,
                    level=level,
                )
            )
            return
        except Exception:
            # Retries exhausted: isolate per request, in front of the
            # in-flight window (these requests never reached the device).
            self._isolate(engine, batch, k, level)
            t1 = self.clock()
            self.completed.extend(batch)
            self.steps.append(
                StepRecord(
                    n_requests=len(batch),
                    k=k,
                    bucket=batch_bucket(len(batch), engine.policy.batch_buckets),
                    step_s=t1 - t0,
                    compile_count=self.executables,
                    dispatch_s=t1 - t0,
                    level=level,
                )
            )
            return
        self._inflight.append(
            _Inflight(batch, k, res, t0, dispatch_s=self.clock() - t0, level=level)
        )

    def _retire(self) -> list[AnnRequest]:
        """Materialise the oldest in-flight batch (blocks until it is done)."""
        fl = self._inflight.popleft()
        try:
            # The ONE intentional blocking point of the async hot path:
            # retiring the oldest in-flight batch materialises its results.
            ids = fl.result.ids.cpu().numpy()  # host-sync: ok — the retire point
            dists = fl.result.dists.cpu().numpy()  # host-sync: ok — the retire point
            t1 = self.clock()
            qb = self._quality_bound(fl.level, fl.k)
            for i, r in enumerate(fl.batch):
                r.ids, r.dists, r.t_done = ids[i], dists[i], t1
                r.degrade_level, r.quality_bound = fl.level, qb
        except Exception as e:
            # A batch that poisons materialisation fails alone; batches
            # behind it in the window are unaffected.
            t1 = self.clock()
            for r in fl.batch:
                r.error, r.t_done = f"{type(e).__name__}: {e}", t1
        self.completed.extend(fl.batch)
        self.steps.append(
            StepRecord(
                n_requests=len(fl.batch),
                k=fl.k,
                bucket=batch_bucket(
                    len(fl.batch),
                    self._engine_for(fl.level).policy.batch_buckets,
                ),
                step_s=t1 - fl.t_dispatch,
                compile_count=self.executables,
                dispatch_s=fl.dispatch_s,
                level=fl.level,
            )
        )
        return fl.batch

    def step(self) -> list[AnnRequest]:
        """Dispatch the next micro-batch; retire batches past the window.

        Returns the requests *completed* this step (possibly none — the
        freshly dispatched batch completes on a later step).
        """
        before = len(self.completed)
        self._expire_overdue(self.clock())
        if self.queue:
            self._dispatch()
        while len(self._inflight) > self.depth:
            self._retire()
        return self.completed[before:]

    def flush(self) -> list[AnnRequest]:
        """Materialise every in-flight batch (result delivery barrier)."""
        done: list[AnnRequest] = []
        while self._inflight:
            done.extend(self._retire())
        return done

    def swap(self, engine: SuCoEngine, *, ladder: DegradationLadder | None = None) -> None:
        """Retire every in-flight batch on the old engine, then cut over.

        In-flight result tensors would stay valid across the cutover (the
        predecessor's tensors stay referenced until ``release_retired``),
        but retiring them first keeps the handoff contract simple: every
        answer delivered after ``swap`` returns was computed on the
        successor.  Queued-but-undispatched requests ride
        through and dispatch on the new engine — nothing is dropped.
        """
        self.flush()
        super().swap(engine, ladder=ladder)

    def run_until_drained(self) -> list[AnnRequest]:
        while self.queue:
            self.step()
        self.flush()
        return self.completed


def latency_summary(requests: Sequence[AnnRequest]) -> dict:
    """QPS + latency percentiles for a completed request set.

    End-to-end latency is split into its queueing (admission -> dispatch)
    and execution (dispatch -> materialisation) components so pipelined
    and synchronous runs can be compared on where requests spend time,
    not just on the total.  The resilience outcomes are reported
    distinctly: shed (admission rejected), expired (deadline unreachable),
    failed (dispatch error), and degraded answers with the worst
    Theorem-2 ``quality_bound`` any answer carried.  ``deadline_hit_rate``
    is over the requests that had a deadline (1.0 when none did).
    """
    done = [r for r in requests if r.done]
    n_shed = sum(1 for r in requests if r.shed)
    n_expired = sum(1 for r in requests if r.expired)
    n_failed = sum(
        1 for r in requests if r.error is not None and not (r.shed or r.expired)
    )
    n_degraded = sum(1 for r in done if r.degrade_level > 0)
    # Hit rate is over ADMITTED deadlined requests: a shed request was
    # rejected explicitly at admission (reported as n_shed) — the point of
    # admission control is converting silent deadline misses into early
    # rejections, so sheds must not double-count as misses.  Expired
    # requests were admitted and do count as misses.
    with_deadline = [
        r for r in requests if r.t_deadline < math.inf and not r.shed
    ]
    deadline_hit_rate = (
        sum(1 for r in with_deadline if r.hit_deadline) / len(with_deadline)
        if with_deadline
        else 1.0
    )
    bounds = [r.quality_bound for r in done if r.quality_bound is not None]
    resilience = dict(
        n_shed=n_shed,
        n_expired=n_expired,
        n_failed=n_failed,
        n_degraded=n_degraded,
        degraded_fraction=n_degraded / len(done) if done else 0.0,
        deadline_hit_rate=deadline_hit_rate,
        quality_bound_min=float(min(bounds)) if bounds else 1.0,
    )
    if not done:
        # Zeroed summary with the full key set: consumers (the CLI report,
        # dashboards) index these keys unconditionally, and np.percentile on
        # an empty array raises.
        return dict(
            n_requests=0,
            qps=0.0,
            p50_ms=0.0,
            p99_ms=0.0,
            mean_ms=0.0,
            max_ms=0.0,
            queue_p50_ms=0.0,
            queue_p99_ms=0.0,
            exec_p50_ms=0.0,
            exec_p99_ms=0.0,
            **resilience,
        )
    lat = np.asarray([r.latency_s for r in done])
    queue = np.asarray([r.queue_s for r in done])
    execu = np.asarray([r.exec_s for r in done])
    wall = max(r.t_done for r in done) - min(r.t_submit for r in done)
    return dict(
        n_requests=len(done),
        qps=len(done) / wall if wall > 0 else float("inf"),
        p50_ms=float(np.percentile(lat, 50) * 1e3),
        p99_ms=float(np.percentile(lat, 99) * 1e3),
        mean_ms=float(lat.mean() * 1e3),
        max_ms=float(lat.max() * 1e3),
        queue_p50_ms=float(np.percentile(queue, 50) * 1e3),
        queue_p99_ms=float(np.percentile(queue, 99) * 1e3),
        exec_p50_ms=float(np.percentile(execu, 50) * 1e3),
        exec_p99_ms=float(np.percentile(execu, 99) * 1e3),
        **resilience,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync", action="store_true",
                    help="use the synchronous step loop (default: pipelined)")
    ap.add_argument("--depth", type=int, default=2,
                    help="pipelined in-flight window (ignored with --sync)")
    ap.add_argument("--device", default="cuda", help='"cuda" (the card) or "cpu"')
    args = ap.parse_args()

    from repro_torch.data import make_dataset

    ds = make_dataset("gaussian_mixture", args.n, args.d, m=1, k=10, seed=args.seed)
    engine = SuCoEngine.build(
        ds.x,
        SuCoConfig(n_subspaces=8, sqrt_k=16, kmeans_iters=4, seed=args.seed),
        policy=EnginePolicy(alpha=0.05, beta=0.02),
        device=args.device,
    )
    rng = np.random.default_rng(args.seed)
    # cover every bucket a <= max_batch micro-batch can land in
    engine.warmup(batch_sizes=range(1, args.max_batch + 1), ks=(5, 10))
    if args.sync:
        server = AnnServer(engine, max_batch=args.max_batch)
    else:
        server = AsyncAnnServer(engine, max_batch=args.max_batch, depth=args.depth)
    server.submit_many(
        AnnRequest(i, ds.x[rng.integers(0, args.n)], k=int(rng.choice([5, 10])))
        for i in range(args.requests)
    )
    done = server.run_until_drained()
    s = latency_summary(done)
    print(
        f"[ann-serve{'' if args.sync else '-async'}] "
        f"{s['n_requests']} requests in {len(server.steps)} steps: "
        f"{s['qps']:.1f} qps, p50 {s['p50_ms']:.1f} ms, p99 {s['p99_ms']:.1f} ms "
        f"(queue p50 {s['queue_p50_ms']:.1f} / exec p50 {s['exec_p50_ms']:.1f}), "
        f"executables {engine.compile_count}"
    )


if __name__ == "__main__":
    main()
