"""Drift-triggered re-cluster and warm handoff for a mutating serving index.

The counterpart of the JAX package's ``repro.serve.mutation``, class for
class.  The engine gives live mutation its mechanics: slot inserts against
frozen centroids (:meth:`repro_torch.core.suco.SuCoEngine.insert`),
tombstoned deletes (:meth:`~repro_torch.core.suco.SuCoEngine.delete`) and
the warm :meth:`~repro_torch.core.suco.SuCoEngine.swap`.  This module adds
the policy that decides when mutation has degraded the index enough to
rebuild it, and the rebuild itself, without the server dropping a request:

* :class:`DriftMonitor` compares the live per-subspace cell occupancy with
  a baseline (total-variation distance), beside the tombstoned fraction,
  the slot fill fraction and the ratio of insert assignment inertia to the
  baseline corpus inertia (TaCo's observation: re-cluster when the observed
  statistics drift from what the centroids were trained on).
* :class:`MutationManager` owns insert / delete / re-index over an
  :class:`~repro_torch.serve.ann.AnnServer`: external keys across slot
  renumbering, the ``minibatch`` re-cluster of the live corpus into a
  successor engine, its warm-up level for level over exactly the
  ``(bucket, k)`` pairs the old surface has served, and the swap.

A re-index runs in three phases: gather (on the serving thread), prepare
(anywhere: :meth:`MutationManager.reindex_async` runs it off the serving
thread) and commit (on the serving thread, between steps).

On the card the phases are ordered by streams and events, not by host
waits:

* **gather** copies the live rows into a private device tensor (an
  ``index_select`` of the live slots on the serving stream): the card's
  counterpart of the JAX package's host gather.  The prepare never reads
  live mutable state, and the corpus does not cross PCIe twice.  The
  tombstone of the assigned slots (one byte a slot) comes to the host for
  the key table, which stays on the host with the ``seen`` lists.  An event
  recorded after the copy is what the prepare waits on.
* **prepare** (the minibatch build and every level's warm-up) runs on the
  current stream of its thread: a stream the manager owns when it runs off
  the serving thread, with inference mode and the current device set on
  that thread.  It ends by recording an event, and marks the successor's
  tensors as used by the serving stream (``record_stream``), so the caching
  allocator never hands their blocks to a later prepare while serving work
  still reads them.
* **commit** makes the caller's current stream wait on the prepare's event
  before :meth:`~repro_torch.serve.ann.AnnServer.swap`.

On the CPU there are no streams or events, and each of these steps is
skipped: the engine's device decides.

The handoff contract: the successor is warmed before the swap, the swap is
in-place adoption on the old engine objects, and queued requests ride
through, so across a re-index no new ``(bucket, k)`` pair is met on either
engine and no request is dropped, failed or answered with a tombstoned id.

Usage (see ``tests/test_torch_mutation.py``)::

    manager = MutationManager(server, build_config)
    manager.insert(new_rows)          # slot inserts
    manager.delete(stale_keys)        # tombstones, invisible next batch
    report = manager.maybe_reindex()  # re-cluster + warm swap if drifted
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time

import numpy as np
import torch

from repro_torch.core.suco import (
    CapacityError,
    SuCoConfig,
    SuCoEngine,
    assign_points,
    build_index,
)
from repro_torch.serve.ann import AnnServer, DegradationLadder

__all__ = [
    "DriftReport",
    "DriftMonitor",
    "MutationManager",
    "ReindexInProgressError",
    "warm_like",
]


class ReindexInProgressError(RuntimeError):
    """A re-index is already in flight: the single-flight guard rejects a
    second one (and rejects inserts / deletes while an asynchronous prepare
    is pending, so the gathered corpus cannot go stale under it)."""


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One drift observation: the statistics and which thresholds fired."""

    tv_distance: float  # max over subspaces, occupancy vs baseline
    dead_fraction: float  # tombstoned fraction of assigned slots
    fill_fraction: float  # assigned slots / capacity
    inertia_ratio: float  # insert assignment inertia / baseline (1.0 = none)
    reasons: tuple[str, ...]  # empty = no re-cluster needed

    @property
    def triggered(self) -> bool:
        return bool(self.reasons)


def _occupancy(counts: np.ndarray) -> np.ndarray:
    """Per-subspace live-count distribution ``(Ns, K) -> (Ns, K)``, rows
    summing to 1 (uniform for an empty subspace, so TV stays defined)."""
    counts = np.maximum(counts.astype(np.float64), 0.0)
    tot = counts.sum(axis=1, keepdims=True)
    k = counts.shape[1]
    return np.where(tot > 0, counts / np.maximum(tot, 1.0), 1.0 / k)


class DriftMonitor:
    """Occupancy / inertia drift detector against a captured baseline.

    :meth:`capture` takes the engine's live per-subspace cell occupancy and
    the mean per-point assignment inertia of the live corpus under the
    current centroids; :meth:`observe` compares the engine's statistics with
    them and returns a :class:`DriftReport` whose ``reasons`` name every
    threshold crossed:

    * ``tv_threshold``: largest per-subspace total-variation distance
      between the live occupancy and the baseline;
    * ``max_dead_fraction``: tombstones are scored then masked, so a mostly
      dead slot range wants compaction;
    * ``max_fill_fraction``: re-index before inserts raise
      :class:`~repro_torch.core.suco.CapacityError`;
    * ``inertia_ratio_threshold``: inserts assigning with much higher
      inertia than the corpus the centroids were trained on.

    Each observation reads ``cell_counts`` and the engine's insert inertia
    (a device scalar) back to the host, once each.
    """

    def __init__(
        self,
        *,
        tv_threshold: float = 0.15,
        max_dead_fraction: float = 0.25,
        max_fill_fraction: float = 0.9,
        inertia_ratio_threshold: float = 2.0,
    ):
        if not 0.0 < tv_threshold <= 1.0:
            raise ValueError(f"tv_threshold must be in (0, 1], got {tv_threshold}")
        if not 0.0 < max_dead_fraction <= 1.0:
            raise ValueError(f"max_dead_fraction must be in (0, 1], got {max_dead_fraction}")
        if not 0.0 < max_fill_fraction <= 1.0:
            raise ValueError(f"max_fill_fraction must be in (0, 1], got {max_fill_fraction}")
        if inertia_ratio_threshold <= 1.0:
            raise ValueError(
                f"inertia_ratio_threshold must be > 1, got {inertia_ratio_threshold}"
            )
        self.tv_threshold = tv_threshold
        self.max_dead_fraction = max_dead_fraction
        self.max_fill_fraction = max_fill_fraction
        self.inertia_ratio_threshold = inertia_ratio_threshold
        self._baseline: np.ndarray | None = None
        self._baseline_inertia = 0.0

    def capture(self, engine: SuCoEngine) -> "DriftMonitor":
        """Take ``engine``'s live statistics as the new baseline."""
        counts = engine.index.cell_counts.cpu().numpy()  # host-sync: ok — baseline snapshot
        self._baseline = _occupancy(counts)
        self._baseline_inertia = _corpus_inertia(engine)
        return self

    def observe(self, engine: SuCoEngine) -> DriftReport:
        """Compare ``engine``'s live statistics with the baseline."""
        if self._baseline is None:
            raise ValueError("no baseline captured — call capture(engine) first")
        counts = engine.index.cell_counts.cpu().numpy()  # host-sync: ok — drift statistics
        occ = _occupancy(counts)
        tv = float(np.max(0.5 * np.abs(occ - self._baseline).sum(axis=1)))
        assigned = int(engine._next_slot)
        dead = (assigned - engine.n_live) / max(assigned, 1)
        cap = engine.capacity
        fill = assigned / cap if cap else 1.0
        base = self._baseline_inertia
        inserted = engine._inserted
        inertia = engine._insert_inertia.item()  # host-sync: ok — drift statistics
        per_insert = inertia / inserted if inserted else 0.0
        ratio = per_insert / base if (per_insert > 0 and base > 0) else 1.0
        reasons = []
        if tv >= self.tv_threshold:
            reasons.append(f"occupancy tv {tv:.3f} >= {self.tv_threshold}")
        if dead >= self.max_dead_fraction:
            reasons.append(f"dead fraction {dead:.3f} >= {self.max_dead_fraction}")
        if fill >= self.max_fill_fraction:
            reasons.append(f"fill fraction {fill:.3f} >= {self.max_fill_fraction}")
        if ratio >= self.inertia_ratio_threshold:
            reasons.append(
                f"insert inertia ratio {ratio:.2f} >= {self.inertia_ratio_threshold}"
            )
        return DriftReport(
            tv_distance=tv,
            dead_fraction=float(dead),
            fill_fraction=float(fill),
            inertia_ratio=float(ratio),
            reasons=tuple(reasons),
        )


def _corpus_inertia(engine: SuCoEngine) -> float:
    """Mean per-point assignment inertia of the live corpus under the
    engine's centroids: what the insert-inertia drift signal is a ratio
    against.  One assignment pass on the engine's device."""
    slots = _live_slots(engine)
    if slots.size == 0:
        return 0.0
    idx = engine.index
    _, _, inertia = assign_points(
        _gather_rows(engine, slots),
        idx.centroids1,
        idx.centroids2,
        spec=idx.spec,
        sqrt_k=idx.sqrt_k,
        block_n=engine.policy.block_n,
    )
    return inertia.item() / slots.size  # host-sync: ok — drift baseline


def _live_slots(engine: SuCoEngine) -> np.ndarray:
    """Slot ids of the live (assigned, non-tombstoned) points, on the host."""
    assigned = int(engine._next_slot)
    tomb = engine.index.tombstone
    if tomb is None:
        return np.arange(assigned)
    dead = tomb[:assigned].cpu().numpy()  # host-sync: ok — live slots for the key table
    return np.flatnonzero(~dead)


def _gather_rows(engine: SuCoEngine, slots: np.ndarray) -> torch.Tensor:
    """A private copy of rows ``slots`` of ``x``, on the engine's device."""
    rows = torch.from_numpy(slots).to(device=engine.x.device, dtype=torch.long)
    return engine.x.index_select(0, rows)


def warm_like(new_engine: SuCoEngine, old_engine: SuCoEngine) -> int:
    """Warm ``new_engine`` over exactly the ``(bucket, k)`` pairs
    ``old_engine`` has served (what :meth:`SuCoEngine.swap` requires).
    Returns the pairs new to ``new_engine``."""
    fresh = 0
    for b, k in sorted(old_engine._buckets_seen):
        fresh += new_engine.warmup([b], [k])
    return fresh


def _event(device: torch.device) -> torch.cuda.Event | None:
    """An event recorded on ``device``'s current stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _wait(event: torch.cuda.Event | None, device: torch.device) -> None:
    """Make ``device``'s current stream wait on ``event`` (no host wait)."""
    if event is not None:
        torch.cuda.current_stream(device).wait_event(event)


class MutationManager:
    """Insert / delete / re-index over a serving :class:`AnnServer`.

    Answers carry engine slot ids, and a re-index renumbers slots (the live
    corpus compacts into a fresh engine).  The manager keeps a stable
    external key per slot: :meth:`insert` assigns (or accepts) keys,
    :meth:`delete` tombstones by key and :meth:`keys_of` maps an answer's
    slot ids back to keys, for the engine generation the answer was served
    on (so callers translate ids when they retire a batch).

    :meth:`reindex` is the warm handoff: gather the live rows,
    ``minibatch``-re-cluster them into a successor engine with
    ``capacity_factor`` headroom, warm it (level for level under a
    degradation ladder) over the old surface's seen traffic, then swap.
    :meth:`maybe_reindex` gates it on the :class:`DriftMonitor`;
    :meth:`insert` re-indexes once and retries when the engine is out of
    slots (``auto_reindex``).
    """

    def __init__(
        self,
        server: AnnServer,
        config: SuCoConfig,
        *,
        monitor: DriftMonitor | None = None,
        capacity_factor: float = 2.0,
        auto_reindex: bool = True,
        stats_seed: int = 0,
    ):
        if capacity_factor < 1.0:
            raise ValueError(f"capacity_factor must be >= 1, got {capacity_factor}")
        self.server = server
        self.config = config
        self.capacity_factor = float(capacity_factor)
        self.auto_reindex = auto_reindex
        self.stats_seed = stats_seed
        self.monitor = DriftMonitor() if monitor is None else monitor
        self.monitor.capture(self.engine)
        self.reindexes = 0
        n0 = int(self.engine._next_slot)
        self._keys = np.arange(n0, dtype=np.int64)
        self._next_key = n0
        # A repro_torch.serve.durability.Durability (or None), wired by
        # Durability.attach; a committed re-index is WAL-logged through it.
        self.durability = None
        self._reindex_lock = threading.Lock()  # single-flight claim
        self._reindexing = False
        self._pending: _ReindexJob | None = None
        self._stream: torch.cuda.Stream | None = None  # the off-thread prepare's

    @property
    def engine(self) -> SuCoEngine:
        """The server's base engine (a chaos proxy delegates through)."""
        return self.server.engine

    # ---- key bookkeeping -------------------------------------------------

    def keys_of(self, slot_ids) -> np.ndarray:
        """External keys for engine slot ids of the current generation."""
        return self._keys[np.asarray(slot_ids)]

    def live_keys(self) -> np.ndarray:
        """Keys of the live points."""
        return self._keys[_live_slots(self.engine)]

    # ---- mutation --------------------------------------------------------

    def insert(self, x_new, keys=None) -> np.ndarray:
        """Insert rows through the server (ladder siblings rebind); returns
        their external keys.  Out of slots with ``auto_reindex``: one
        re-index with room for the batch, then a retry."""
        x_new = np.atleast_2d(np.asarray(x_new))
        b = x_new.shape[0]
        if keys is None:
            keys = np.arange(self._next_key, self._next_key + b, dtype=np.int64)
        keys = np.asarray(keys, dtype=np.int64)
        if keys.shape != (b,):
            raise ValueError(f"keys must be ({b},), got {keys.shape}")
        if np.isin(keys, self._keys).any():
            raise ValueError("keys must be fresh — at least one is already in use")
        self._check_no_pending("insert")
        try:
            self.server.insert(x_new, keys=keys)
        except CapacityError:
            if not self.auto_reindex:
                raise
            self.reindex(min_free=b)
            self.server.insert(x_new, keys=keys)
        self._keys = np.concatenate([self._keys, keys])
        if b:
            self._next_key = max(self._next_key, int(keys.max()) + 1)
        return keys

    def delete(self, keys) -> int:
        """Tombstone points by external key; returns the newly deleted count.
        Unknown keys are ignored (delete is idempotent end to end)."""
        keys = np.asarray(keys)
        slots = np.flatnonzero(np.isin(self._keys, keys))
        if slots.size == 0:
            return 0
        self._check_no_pending("delete")
        return self.server.delete(slots)

    # ---- re-index handoff ------------------------------------------------

    def check(self) -> DriftReport:
        """One drift observation against the current baseline."""
        return self.monitor.observe(self.engine)

    def maybe_reindex(self) -> DriftReport:
        """Observe drift; re-cluster and swap warm when a threshold fired."""
        report = self.check()
        if report.triggered:
            self.reindex()
        return report

    def _check_no_pending(self, op: str) -> None:
        if self._pending is not None:
            raise ReindexInProgressError(
                f"{op} rejected: an asynchronous re-index prepare is pending "
                "— finish_reindex() first (mutating now would invalidate the "
                "gathered corpus the successor is being built from)"
            )

    def _claim(self) -> None:
        with self._reindex_lock:
            if self._reindexing:
                raise ReindexInProgressError(
                    "a re-index is already in flight — the single-flight "
                    "guard admits one at a time"
                )
            self._reindexing = True

    def _release(self) -> None:
        with self._reindex_lock:
            self._reindexing = False

    def _gather(self, capacity: int | None, min_free: int) -> "_Gathered":
        """Phase 1, on the serving thread: everything the prepare needs, so
        it never reads live mutable state.  The live rows go into a private
        device copy on the serving stream; the old ladder's ``_buckets_seen``
        sets (which mutate under traffic) are copied."""
        t0 = time.perf_counter()
        old = self.engine
        slots = _live_slots(old)
        n_live = int(slots.size)
        if n_live == 0:
            raise ValueError("cannot re-index an empty live corpus")
        x_live = _gather_rows(old, slots)
        device = x_live.device
        ready = _event(device)
        if capacity is None:
            capacity = int(math.ceil(n_live * self.capacity_factor))
        capacity = max(capacity, n_live + min_free)
        old_ladder = self.server.ladder
        if old_ladder is not None:
            seen = tuple(sorted(e._buckets_seen) for e in old_ladder.engines)
            ladder_meta = (old_ladder.max_level, old_ladder.m_stat, old_ladder.sigma_stat)
        else:
            seen = (sorted(old._buckets_seen),)
            ladder_meta = None
        return _Gathered(
            x_live=x_live,
            live_keys=self._keys[slots],
            capacity=int(capacity),
            min_free=int(min_free),
            policy=dataclasses.replace(old.policy),  # fresh traffic histogram
            seen=seen,
            ladder_meta=ladder_meta,
            device=device,
            serving_stream=(torch.cuda.current_stream(device) if device.type == "cuda"
                            else None),
            ready=ready,
            gather_s=time.perf_counter() - t0,
        )

    def _build_successor(self, g: "_Gathered") -> "_Prepared":
        """Phase 2, on the current stream of whichever thread runs it:
        re-cluster the gathered corpus and warm a successor surface.  It
        touches nothing of the incumbent, so an exception (or an injected
        crash) here leaves the server serving exactly as before."""
        t0 = time.perf_counter()
        _wait(g.ready, g.device)
        if g.serving_stream is not None:  # read here: not reused before this stream is past it
            g.x_live.record_stream(torch.cuda.current_stream(g.device))
        cfg = dataclasses.replace(self.config, build_mode="minibatch")
        index = build_index(g.x_live, cfg)
        if self.durability is not None:
            self.durability.reach("reindex.mid-prepare")
        successor = SuCoEngine(g.x_live, index, g.policy, capacity=g.capacity, device=g.device)
        ladder = None
        if g.ladder_meta is not None:
            levels, m_stat, sigma_stat = g.ladder_meta
            ladder = DegradationLadder(
                successor,
                levels=levels,
                stats=(m_stat, sigma_stat),
                stats_seed=self.stats_seed,
            )
            for pairs, new_e in zip(g.seen, ladder.engines):
                for b, k in pairs:
                    new_e.warmup([b], [k])
        else:
            for b, k in g.seen[0]:
                successor.warmup([b], [k])
        if g.serving_stream is not None:
            idx = successor.index
            for t in (successor.x, idx.cell_ids, idx.cell_counts, idx.tombstone,
                      idx.centroids1, idx.centroids2, successor._insert_inertia):
                t.record_stream(g.serving_stream)
        return _Prepared(gathered=g, successor=successor, ladder=ladder,
                         ready=_event(g.device), prepare_s=time.perf_counter() - t0)

    def _commit(self, p: "_Prepared") -> SuCoEngine:
        """Phase 3, on the serving thread: the warm swap and bookkeeping.
        The serving stream waits for the prepare first.  With a durability
        root attached the committed re-index is WAL-logged (its resolved
        capacity: replay rebuilds the same successor) as the last step,
        after the state it describes exists."""
        _wait(p.ready, p.gathered.device)
        dur = self.durability
        if dur is not None:
            dur._in_reindex = True
        try:
            self.server.swap(p.successor, ladder=p.ladder)
        finally:
            if dur is not None:
                dur._in_reindex = False
        # The cutover is done; drop the predecessor's tensors here, off the
        # serving surface (the manager runs between steps).
        for e in (self.server.ladder.engines if self.server.ladder is not None
                  else [self.engine]):
            e.release_retired()
        self._keys = p.gathered.live_keys
        self.monitor.capture(self.engine)
        self.reindexes += 1
        if dur is not None:
            dur.log_reindex(capacity=p.gathered.capacity, min_free=p.gathered.min_free)
        return self.engine

    def reindex(self, *, capacity: int | None = None, min_free: int = 0) -> SuCoEngine:
        """Re-cluster the live corpus and hand the server over warm.

        Gathers the live rows, rebuilds them with the manager's build config
        forced to ``minibatch`` (no dense ``(n, K)`` pass while serving),
        wraps the new index in a successor engine with ``capacity_factor``
        slot headroom, warms it (level for level under a degradation ladder)
        over the old surface's seen ``(bucket, k)`` traffic, and swaps, all
        on the caller's thread and stream.  Keys compact with the corpus, the
        drift baseline is taken again, and the successor (after adoption,
        ``server.engine``) is returned.

        An exception anywhere before the swap leaves the incumbent serving
        untouched.  Single flight: a concurrent ``reindex`` /
        ``reindex_async`` raises :class:`ReindexInProgressError`.
        """
        self._check_no_pending("reindex")
        self._claim()
        try:
            prepared = self._build_successor(self._gather(capacity, min_free))
            return self._commit(prepared)
        finally:
            self._release()

    # ---- asynchronous prepare (off the serving thread) -------------------

    def _prepare_stream(self, device: torch.device) -> torch.cuda.Stream | None:
        """The stream the off-thread prepare launches on (None on the CPU)."""
        if device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def reindex_async(self, *, capacity: int | None = None, min_free: int = 0) -> "_ReindexJob":
        """Start the re-cluster prepare off the serving thread and return at
        once: the server keeps answering while the successor builds on the
        manager's own stream.  :meth:`finish_reindex` joins the job and
        commits the warm swap on the caller's thread.  A prepare failure is
        contained: ``finish_reindex`` re-raises it and the incumbent is
        untouched.

        The prepare runs on the durability maintenance thread when one is
        attached (the thread that group-commits the WAL, whose commits wait
        while it builds), else on a thread of its own.
        """
        self._check_no_pending("reindex_async")
        self._claim()
        try:
            g = self._gather(capacity, min_free)
            job = _ReindexJob(self, g, self._prepare_stream(g.device))
        except BaseException:
            self._release()
            raise
        self._pending = job
        dur = self.durability
        if dur is not None and dur.worker is not None:
            dur.worker.submit(job.run)
        else:
            threading.Thread(target=job.run, name="suco-reindex-prepare", daemon=True).start()
        return job

    def finish_reindex(self, *, timeout: float | None = None) -> SuCoEngine:
        """Join the pending asynchronous prepare and commit the swap.

        If the prepare raised (an injected :class:`CrashPoint` too), the
        exception is raised again here, the pending job is cleared, and the
        incumbent keeps serving: nothing was mutated.
        """
        job = self._pending
        if job is None:
            raise ValueError("no asynchronous re-index is pending")
        try:
            prepared = job.wait(timeout=timeout)
        except TimeoutError:
            raise  # still pending: call finish_reindex() again
        except BaseException:
            self._pending = None
            self._release()
            raise
        try:
            return self._commit(prepared)
        finally:
            self._pending = None
            self._release()

    # ---- durability ------------------------------------------------------

    def save(self, path) -> None:
        """One-shot durable save of the whole serving stack (engine, ladder
        statistics, warm surface and this manager's key table) as an atomic,
        checksummed version-3 artifact;
        :func:`repro_torch.serve.durability.load_serving_stack` reads it."""
        from repro_torch.serve.durability import save_stack  # lazy: avoid a cycle

        save_stack(path, self.server, self, config=self.config)


@dataclasses.dataclass(frozen=True)
class _Gathered:
    """What the serving thread hands to the prepare."""

    x_live: torch.Tensor  # private copy of the live rows, on the engine's device
    live_keys: np.ndarray
    capacity: int
    min_free: int
    policy: object
    seen: tuple  # per-level sorted (bucket, k) lists, copied
    ladder_meta: tuple | None  # (levels, m_stat, sigma_stat) or None
    device: torch.device
    serving_stream: torch.cuda.Stream | None  # the stream the gather ran on
    ready: torch.cuda.Event | None  # recorded after the copy
    gather_s: float  # host seconds of the gather, on the serving thread


@dataclasses.dataclass(frozen=True)
class _Prepared:
    gathered: _Gathered
    successor: SuCoEngine
    ladder: DegradationLadder | None
    ready: torch.cuda.Event | None  # recorded at the end of the prepare
    prepare_s: float  # host seconds of the prepare, on its thread


class _ReindexJob:
    """One asynchronous prepare: runs :meth:`MutationManager._build_successor`
    on whatever thread it is scheduled, on ``stream`` there with inference
    mode and the device set, captures any failure (``BaseException``: an
    injected crash must not kill the worker thread) and hands the result
    back on :meth:`wait`."""

    def __init__(self, manager: MutationManager, gathered: _Gathered,
                 stream: torch.cuda.Stream | None):
        self._manager = manager
        self._gathered = gathered
        self._stream = stream
        self._done = threading.Event()
        self._result: _Prepared | None = None
        self._error: BaseException | None = None

    def run(self) -> None:
        try:
            with contextlib.ExitStack() as ctx:
                ctx.enter_context(torch.inference_mode())
                if self._stream is not None:
                    # the current device and stream are per thread
                    ctx.enter_context(torch.cuda.device(self._gathered.device))
                    ctx.enter_context(torch.cuda.stream(self._stream))
                self._result = self._manager._build_successor(self._gathered)
        except BaseException as e:  # noqa: BLE001 — containment by design
            self._error = e
        finally:
            self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, *, timeout: float | None = None) -> _Prepared:
        if not self._done.wait(timeout=timeout):
            raise TimeoutError("re-index prepare still running")
        if self._error is not None:
            raise self._error
        return self._result
