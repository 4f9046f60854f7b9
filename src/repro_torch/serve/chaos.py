"""Deterministic fault injection for the ANN serving stack.

The counterpart of the JAX package's ``repro.serve.chaos``.  Chaos testing
of :mod:`repro_torch.serve.ann` without wall clocks or real failures: a
:class:`VirtualClock` replaces ``time.perf_counter`` (the servers take
``clock`` / ``sleep`` callables for this), and a :class:`ChaosEngine` wraps
a real :class:`~repro_torch.core.suco.SuCoEngine`, drawing every injected
fault (engine exceptions, latency spikes) from one seeded numpy Generator
whose consumption order is fixed by the replay's event order.  Replaying
the same trace with the same :class:`ChaosConfig` gives the same schedule:
the same requests shed, expired, degraded and failed (:func:`replay`
returns the outcome sets as frozensets, so tests compare them directly).

Injectors (all seeded, all off by default):

* **engine exception**: ``p_engine_error`` chance a dispatch raises
  :class:`ChaosError` (retry with backoff, per-request isolation);
* **latency spike**: ``p_latency_spike`` chance a dispatch takes
  ``latency_spike_s`` more virtual seconds (deadline expiry);
* **malformed query**: :func:`flood_trace` poisons a fraction of requests
  with NaN (submit-time validation);
* **queue flood**: :func:`flood_trace` draws arrivals faster than the
  service time (admission control, the degradation ladder);
* **shard death**: :func:`kill_pool_engine` makes one k-class of a
  sharded engine pool raise on every query (its ``query_resilient`` must
  rebind the class);
* **process death**: :class:`CrashInjector` raises :class:`CrashPoint` at
  one of the durability layer's boundaries (:data:`CRASH_POINTS`: WAL
  append / fsync, snapshot write / rename, log truncation, the off-thread
  re-index prepare); :func:`recovery_drill` kills a durable stack there,
  recovers it from disk and checks the no-acknowledged-loss, bit-identical
  contract of :mod:`repro_torch.serve.durability`.

Usage (see ``tests/test_torch_chaos.py``)::

    clock = VirtualClock()
    chaos = ChaosEngine(engine, ChaosConfig(seed=0, p_engine_error=0.05), clock=clock)
    server = AsyncAnnServer(chaos, clock=clock, sleep=clock.advance, max_queue=64,
                            ladder=ladder, controller=OverloadController())
    report = replay(server, flood_trace(...), clock)
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from repro_torch.serve.ann import AnnRequest, AnnServer, latency_summary

__all__ = [
    "ChaosError",
    "VirtualClock",
    "ChaosConfig",
    "ChaosEngine",
    "wrap_ladder",
    "ReplayReport",
    "flood_trace",
    "replay",
    "CrashPoint",
    "CrashInjector",
    "CRASH_POINTS",
    "DrillStep",
    "DrillReport",
    "drill_steps",
    "recovery_drill",
    "kill_pool_engine",
]


class ChaosError(RuntimeError):
    """The injected transient engine failure (never raised by real code)."""


class VirtualClock:
    """A deterministic clock: time moves only when ``advance`` is called.

    It is the server's ``clock`` (it is callable) and, through ``advance``,
    its ``sleep``, so retry backoff spends virtual time.
    """

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"time cannot go backwards (dt={dt})")
        self.t += float(dt)
        return self.t


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault-injection plan for one replay."""

    seed: int = 0
    service_s: float = 0.001  # virtual execution time per dispatch
    p_engine_error: float = 0.0  # chance a dispatch raises ChaosError
    p_latency_spike: float = 0.0  # chance a dispatch stalls extra
    latency_spike_s: float = 0.05  # the stall

    def __post_init__(self):
        for name in ("p_engine_error", "p_latency_spike"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")


class ChaosEngine:
    """A :class:`~repro_torch.core.suco.SuCoEngine` proxy that injects faults.

    Every ``query`` advances the virtual clock by ``service_s``, then draws
    exactly two uniforms from the shared schedule (the spike's, the
    error's), so the fault sequence is a function of ``(seed, dispatch
    order)`` alone.  Everything else (``policy``, ``compile_count``,
    ``index``, ...) delegates to the wrapped engine, so servers and ladders
    take the proxy for the engine.
    """

    def __init__(
        self,
        engine,
        config: ChaosConfig,
        clock: VirtualClock,
        *,
        rng: np.random.Generator | None = None,
    ):
        self._engine = engine
        self._config = config
        self._clock = clock
        # an injected rng lets several proxies (every level of a ladder, via
        # wrap_ladder) consume ONE fault schedule in global dispatch order
        self._rng = np.random.default_rng(config.seed) if rng is None else rng
        self.n_dispatches = 0
        self.n_errors = 0
        self.n_spikes = 0

    def query(self, q, k: int):
        c = self._config
        self.n_dispatches += 1
        # a fixed draw count per dispatch keeps the schedule aligned across
        # replays even when an earlier injector fires
        u_spike, u_err = self._rng.random(2)
        self._clock.advance(c.service_s)
        if u_spike < c.p_latency_spike:
            self.n_spikes += 1
            self._clock.advance(c.latency_spike_s)
        if u_err < c.p_engine_error:
            self.n_errors += 1
            raise ChaosError(f"injected engine failure (dispatch #{self.n_dispatches})")
        return self._engine.query(q, k=k)

    def __getattr__(self, name):
        return getattr(self._engine, name)


def wrap_ladder(ladder, config: ChaosConfig, clock: VirtualClock):
    """Wrap every engine of a :class:`~repro_torch.serve.ann.DegradationLadder`
    in :class:`ChaosEngine` proxies sharing ONE fault schedule (wrapping only
    the base engine would leave the degraded paths free of faults).  Returns
    the ladder, changed in place; pass ``ladder.engines[0]`` as the server's
    engine so level 0 is the same proxy."""
    rng = np.random.default_rng(config.seed)
    ladder.engines = [ChaosEngine(e, config, clock, rng=rng) for e in ladder.engines]
    return ladder


@dataclasses.dataclass(frozen=True)
class ReplayReport:
    """Outcome of one chaos replay, by request id.

    The id sets are frozensets, so determinism tests compare replays with
    ``==``; ``summary`` is :func:`repro_torch.serve.ann.latency_summary` over
    every request of the trace and ``retraces`` the growth of the serving
    surface's (bucket, k) pairs across the replay (0: no new pair under
    chaos).
    """

    completed: frozenset[int]
    shed: frozenset[int]
    expired: frozenset[int]
    failed: frozenset[int]
    degraded: frozenset[int]
    max_level: int
    summary: dict
    retraces: int

    @property
    def outcome_sets(self) -> tuple[frozenset[int], ...]:
        """The determinism-test tuple: equal across equal replays."""
        return (self.completed, self.shed, self.expired, self.failed, self.degraded)


def flood_trace(
    n_requests: int,
    d: int,
    *,
    interarrival_s: float = 0.0002,
    deadline_s: float | None = 0.05,
    ks: Sequence[int] = (10,),
    p_malformed: float = 0.0,
    seed: int = 0,
    queries: np.ndarray | None = None,
) -> list[tuple[float, AnnRequest]]:
    """A seeded ``(arrival_s, request)`` trace for :func:`replay`.

    Arrivals are evenly spaced at ``interarrival_s`` (below the chaos
    ``service_s`` times the batch fill, they flood the admission queue).  A
    ``p_malformed`` fraction of requests gets NaN in one coordinate.
    Queries are rows of ``queries`` when given (so answers compare with a
    clean run), else standard normal draws.  The JAX package's trace, draw
    for draw.
    """
    rng = np.random.default_rng(seed)
    trace: list[tuple[float, AnnRequest]] = []
    for i in range(n_requests):
        if queries is not None:
            row = queries[int(rng.integers(0, len(queries)))]
            q = np.array(row, dtype=np.float32)
        else:
            q = rng.standard_normal(d).astype(np.float32)
        if p_malformed > 0.0 and rng.random() < p_malformed:
            q[int(rng.integers(0, d))] = np.nan
        k = int(ks[int(rng.integers(0, len(ks)))])
        trace.append((i * interarrival_s, AnnRequest(i, q, k=k, deadline_s=deadline_s)))
    return trace


def replay(
    server: AnnServer,
    trace: Sequence[tuple[float, AnnRequest]],
    clock: VirtualClock,
) -> ReplayReport:
    """Drive ``server`` through an arrival trace on the virtual clock.

    Event loop: admit every request whose arrival time has passed, then run
    one server step (which advances the clock through the chaos engine's
    service time); when the server is idle and the next arrival is in the
    future, jump the clock to it.  The loop, and so the fault schedule the
    chaos engine consumes, is a function of (trace, chaos seed, server
    configuration).

    A trace entry may carry a callable instead of a request: it is called as
    ``event(server)`` at its time (how the mutate-while-serving tests script
    inserts, deletes and warm handoffs between dispatches) and is left out
    of the request accounting.
    """
    if any(t1 > t2 for (t1, _), (t2, _) in zip(trace, trace[1:])):
        raise ValueError("trace must be sorted by arrival time")
    exe_before = server.executables
    i = 0
    while True:
        while i < len(trace) and trace[i][0] <= clock():
            ev = trace[i][1]
            if callable(ev):
                ev(server)  # scripted mutation / handoff action
            else:
                server.submit(ev)
            i += 1
        if server.queue:
            server.step()
        elif getattr(server, "inflight", 0):
            server.flush()  # nothing left to dispatch right now: drain
        elif i < len(trace):
            clock.advance(trace[i][0] - clock())
        else:
            break
    reqs = [r for _, r in trace if not callable(r)]
    done = [r for r in reqs if r.done]
    return ReplayReport(
        completed=frozenset(r.rid for r in done),
        shed=frozenset(r.rid for r in reqs if r.shed),
        expired=frozenset(r.rid for r in reqs if r.expired),
        failed=frozenset(
            r.rid for r in reqs if r.error is not None and not (r.shed or r.expired)
        ),
        degraded=frozenset(r.rid for r in done if r.degrade_level > 0),
        max_level=max((r.degrade_level for r in done), default=0),
        summary=latency_summary(reqs),
        retraces=server.executables - exe_before,
    )


# ---------------------------------------------------------------------------
# Crash-point injection and recovery drills (the durability counterpart of
# the injectors above: repro_torch.serve.durability, docs/durability.md)
# ---------------------------------------------------------------------------


class CrashPoint(BaseException):
    """The injected process death.  A ``BaseException`` on purpose: a real
    crash runs no ``except Exception`` clean-up; only what is on disk
    survives, which is what the drill tests."""


#: Every instrumented write / rename / fsync boundary of the durability
#: layer, the JAX package's ten names.  ``Durability`` / ``WriteAheadLog``
#: call ``injector.reach(point)`` at each; the drill kills at each in turn.
CRASH_POINTS: tuple[str, ...] = (
    "wal.append.pre",  # record not yet written (mutation applied, un-acked)
    "wal.append.torn",  # half a frame on disk: the torn-tail case
    "wal.append.post-write",  # frame fully written, ack never returned
    "wal.fsync.post",  # record durable on storage, ack never returned
    "snapshot.pre",  # before the checkpoint starts
    "snapshot.post-write",  # .writing staged, final name not yet replaced
    "snapshot.post-rename",  # snapshot live, WAL not yet truncated
    "wal.truncate.post-write",  # truncated log staged as .tmp
    "wal.truncate.post-rename",  # truncated log live, handle not reopened
    "reindex.mid-prepare",  # the re-cluster prepare died mid-build
)


class CrashInjector:
    """Arms one :data:`CRASH_POINTS` name and raises :class:`CrashPoint` the
    first time the durability layer reaches it.  ``reached`` records every
    boundary crossed, armed or not: the ledger that proves each point
    fires."""

    def __init__(self, armed: str | None = None):
        self.armed = armed
        self.fired = False
        self.reached: list[str] = []

    def arm(self, point: str) -> "CrashInjector":
        if point not in CRASH_POINTS:
            raise ValueError(f"unknown crash point {point!r}")
        self.armed = point
        self.fired = False
        return self

    def reach(self, point: str) -> None:
        self.reached.append(point)
        if self.armed == point and not self.fired:
            self.fired = True
            raise CrashPoint(point)


@dataclasses.dataclass(frozen=True)
class DrillStep:
    """One scripted action of a recovery drill.

    ``kind``: ``"insert"`` (payload = rows), ``"delete"`` (payload =
    external keys), ``"reindex"``, ``"snapshot"`` or ``"flush"`` (the group
    commit, driven synchronously so drills stay deterministic).
    """

    kind: str
    payload: np.ndarray | None = None

    @property
    def records(self) -> int:
        """WAL records this step appends when fully acknowledged."""
        return 1 if self.kind in ("insert", "delete", "reindex") else 0


def drill_steps(d: int, *, seed: int = 0) -> list[DrillStep]:
    """The standard drill script, the JAX package's draw for draw: every
    :data:`CRASH_POINTS` boundary is reachable from it under both fsync
    policies.  The explicit ``flush`` fires ``wal.fsync.post`` under group
    commit (under per-record fsync it fires at the first insert); the
    explicit ``snapshot`` precedes the re-index so the ``snapshot.*`` /
    ``wal.truncate.*`` points fire at a scripted boundary."""
    rng = np.random.default_rng(seed)
    row = lambda b: rng.standard_normal((b, d)).astype(np.float32)  # noqa: E731
    return [
        DrillStep("insert", row(3)),
        DrillStep("flush"),
        DrillStep("delete", np.asarray([0, 1], np.int64)),
        DrillStep("snapshot"),
        DrillStep("insert", row(2)),
        DrillStep("reindex"),
        DrillStep("insert", row(2)),
    ]


@dataclasses.dataclass(frozen=True)
class DrillReport:
    """Outcome of one kill -> recover -> verify drill."""

    crash_point: str
    fired: bool  # the armed boundary was actually reached
    acked: int  # mutation records acknowledged before the kill
    applied: int  # records reflected in the recovered state
    lost_acked: int  # max(0, acked - applied): MUST be 0
    bit_identical: bool  # fingerprints equal the crash-free reference's
    fingerprint_diff: tuple[str, ...]
    retraces_after_warmup: int  # new (bucket, k) pairs while serving: MUST be 0
    answers_match: bool  # recovered answers == reference answers
    quality_bounds_match: bool  # Theorem-2 floors agree with the reference
    dropped_bytes: int  # torn WAL tail truncated during recovery
    snapshots_skipped: int


def _apply_drill_step(server, manager, dur, step: DrillStep) -> None:
    if step.kind == "insert":
        manager.insert(step.payload)
    elif step.kind == "delete":
        manager.delete(step.payload)
    elif step.kind == "reindex":
        manager.reindex()
    elif step.kind == "snapshot":
        dur.snapshot()
    elif step.kind == "flush":
        dur.flush()
    else:
        raise ValueError(f"unknown drill step kind {step.kind!r}")


def _drill_answers(server, queries, k: int):
    """Serve ``queries`` one at a time (the warmed batch-1 bucket) and
    return their ``(ids, dists)`` in order."""
    out = []
    for i, q in enumerate(queries):
        req = AnnRequest(i, np.asarray(q, np.float32), k=k)
        server.submit(req)
        while server.queue:
            server.step()
        if getattr(server, "inflight", 0):
            server.flush()
        out.append((req.ids, req.dists))
    return out


def recovery_drill(
    root,
    build: Callable,
    steps: Sequence[DrillStep],
    crash_point: str,
    *,
    queries: np.ndarray,
    k: int = 10,
    recover_kwargs: dict | None = None,
) -> DrillReport:
    """Kill a durable serving stack at ``crash_point``, recover it, and check
    the durability contract against a crash-free reference.

    ``build(dir, injector)`` makes a fresh serving stack rooted at ``dir``
    and returns ``(server, manager, durability)``, the injector wired into
    the :class:`~repro_torch.serve.durability.Durability` (``crash=``) and
    ``start_worker=False`` (drills drive the group commit themselves, so the
    kill schedule is deterministic).  Recovery runs on the crashed stack's
    device unless ``recover_kwargs`` names another.

    Protocol: build -> clean baseline snapshot -> arm -> run ``steps``
    counting acknowledged records until :class:`CrashPoint` (or the end) ->
    abandon (no final flush) -> :func:`repro_torch.serve.durability.recover`
    -> build a reference stack in a sibling directory and apply the
    acknowledged prefix without a crash -> compare:

    * no acknowledged record lost (``applied >= acked``; one past is a
      record framed whose ack never returned);
    * state fingerprints bit-identical to the reference's;
    * answers equal, with no new (bucket, k) pair while serving (the
      snapshot's warm surface covers the traffic);
    * Theorem-2 quality floors equal to the reference ladder's.
    """
    root = Path(root)
    crash_dir, ref_dir = root / "crash", root / "ref"
    injector = CrashInjector()
    server, manager, dur = build(crash_dir, injector)
    dur.snapshot()  # clean baseline: every drill starts recoverable
    injector.arm(crash_point)
    acked = 0
    try:
        for step in steps:
            _apply_drill_step(server, manager, dur, step)
            acked += step.records
    except CrashPoint:
        pass
    dur.abandon()  # process death: no orderly flush

    from repro_torch.serve.durability import (  # lazy: chaos imports light
        fingerprint_diff,
        recover,
        state_fingerprint,
    )

    kwargs = {"device": server.engine.device, **(recover_kwargs or {})}
    rec = recover(crash_dir, start_worker=False, **kwargs)
    applied = rec.report.applied_records

    ref_server, ref_manager, ref_dur = build(ref_dir, CrashInjector())
    cum = 0
    for step in steps:
        if cum + step.records > applied:
            break
        _apply_drill_step(ref_server, ref_manager, ref_dur, step)
        cum += step.records

    diff = fingerprint_diff(
        state_fingerprint(rec.server, rec.manager),
        state_fingerprint(ref_server, ref_manager),
    )
    exe0 = rec.server.executables
    got = _drill_answers(rec.server, queries, k)
    retraces = rec.server.executables - exe0
    want = _drill_answers(ref_server, queries, k)
    answers_match = all(
        np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]) for g, w in zip(got, want)
    )
    bounds_match = True
    if rec.server.ladder is not None and ref_server.ladder is not None:
        bounds_match = all(
            rec.server.ladder.quality_bound(lv, k) == ref_server.ladder.quality_bound(lv, k)
            for lv in range(rec.server.ladder.max_level + 1)
        )
    rec.durability.close()
    ref_dur.close()
    return DrillReport(
        crash_point=crash_point,
        fired=injector.fired,
        acked=acked,
        applied=applied,
        lost_acked=max(0, acked - applied),
        bit_identical=not diff,
        fingerprint_diff=diff,
        retraces_after_warmup=retraces,
        answers_match=answers_match,
        quality_bounds_match=bounds_match,
        dropped_bytes=rec.report.dropped_bytes,
        snapshots_skipped=rec.report.snapshots_skipped,
    )


def kill_pool_engine(pool, k: int, reason: str = "injected shard death") -> None:
    """Make ``pool``'s per-``k`` engine raise :class:`ChaosError` on every
    query: the shard-death injector for
    :meth:`~repro_torch.distributed.engine.ShardedEnginePool.query_resilient`,
    which must rebind the dead k-class to a healthy engine."""
    engine = pool.engine_for(k)

    def _dead_query(q, k=k, **kw):
        raise ChaosError(f"{reason} (k={k})")

    engine.query = _dead_query
