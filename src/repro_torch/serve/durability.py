"""Durability for the mutable serving index: WAL, snapshots, recovery.

The counterpart of the JAX package's ``repro.serve.durability``, with its
contract (``docs/durability.md``) and its on-disk formats byte for byte: a
log or a snapshot written by either package is read by the other.

* Every acknowledged ``insert`` / ``delete`` / ``reindex`` appends a
  CRC32-checksummed, length-prefixed record to a write-ahead log
  (:class:`WriteAheadLog`, magic ``SUCOWAL1``) after the in-memory apply
  and before the call returns: a redo log.  An acknowledged mutation is
  always fully framed on disk; an unacknowledged one may be lost.
* The fsync policy decides when a framed record is durable on storage:
  ``"always"`` fsyncs each record before the return (the serving path pays),
  ``"group"`` (default) marks the log dirty for the
  :class:`MaintenanceWorker` thread to group-commit within
  ``flush_interval_s``, and ``"off"`` trusts the OS page cache.
* :meth:`Durability.snapshot` writes an atomic version-3 artifact
  (:meth:`repro_torch.core.suco.SuCoIndex.save`, a CRC32 per array) with
  the whole serving sidecar: the assigned rows of ``x``, the capacity
  layout, the engine policy, the warm ``(level, bucket, k)`` surface, the
  ladder statistics, the :class:`~repro_torch.serve.mutation.MutationManager`
  key table and the WAL high-water mark; then it truncates the log back to
  the oldest retained snapshot (``snapshot_keep``), so a corrupt newest
  snapshot still falls back to its predecessor and a longer replay.
* :func:`recover` loads the newest snapshot that passes its checksums,
  truncates a torn WAL tail, replays the rest through the real mutation
  surface (``server.insert`` / ``server.delete`` / ``manager.reindex``,
  each deterministic on the port too: the minibatch build draws on CPU
  generators and its kernels give equal bits on two launches) and warms the
  recorded surface again, on the device asked for.

Every write / rename / fsync boundary calls ``reach(point)`` on an injected
:class:`~repro_torch.serve.chaos.CrashInjector`; the recovery drill in
:mod:`repro_torch.serve.chaos` kills the stack at each one.

Every ``os.fsync`` here is off the serving path except the per-record one
the ``"always"`` policy asks for; every host copy of a device tensor carries
a ``# host-sync: ok`` comment (snapshots, fingerprints and WAL payloads).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
import zlib
from collections import deque
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.core.suco import (
    ArtifactError,
    EnginePolicy,
    SuCoEngine,
    load_index_artifact,
)
from repro_torch.core.tuning import TileConfig
from repro_torch.serve.ann import AnnServer, DegradationLadder

__all__ = [
    "WAL_MAGIC",
    "WalRecord",
    "encode_record",
    "decode_records",
    "WriteAheadLog",
    "MaintenanceWorker",
    "DurabilityConfig",
    "Durability",
    "RecoveryError",
    "RecoveryReport",
    "RecoveryResult",
    "recover",
    "save_stack",
    "load_serving_stack",
    "state_fingerprint",
    "fingerprint_diff",
]


class RecoveryError(RuntimeError):
    """Recovery cannot proceed (no valid snapshot, or replay diverged)."""


def _host(a) -> np.ndarray:
    """``a`` as a host array (a device tensor is copied back)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()  # host-sync: ok — WAL payload and sidecar copies
    return np.asarray(a)


# --------------------------------------------------------------------------
# WAL record codec
# --------------------------------------------------------------------------

WAL_MAGIC = b"SUCOWAL1"

_KIND_TO_CODE = {"insert": 1, "delete": 2, "reindex": 3}
_CODE_TO_KIND = {v: k for k, v in _KIND_TO_CODE.items()}


@dataclasses.dataclass(frozen=True, eq=False)
class WalRecord:
    """One logged mutation.  ``seq`` is assigned by the WAL at append time
    (monotone, gapless within a log generation); the payload depends on
    ``kind``:

    * ``"insert"``: ``rows`` (``(b, d)`` float32), ``slots`` (the
      acknowledged engine slots, checked on replay) and ``keys`` (the
      external key table entries);
    * ``"delete"``: ``slots`` (the tombstoned engine slots);
    * ``"reindex"``: the resolved ``capacity`` and ``min_free`` of the
      committed re-cluster, so a replay rebuilds the same successor.
    """

    kind: str
    seq: int = -1
    keys: np.ndarray | None = None
    slots: np.ndarray | None = None
    rows: np.ndarray | None = None
    capacity: int = -1
    min_free: int = 0

    def __eq__(self, other) -> bool:
        if not isinstance(other, WalRecord):
            return NotImplemented

        def arr_eq(a, b):
            if a is None or b is None:
                return a is None and b is None
            return a.dtype == b.dtype and np.array_equal(a, b)

        return (
            self.kind == other.kind
            and self.seq == other.seq
            and self.capacity == other.capacity
            and self.min_free == other.min_free
            and arr_eq(self.keys, other.keys)
            and arr_eq(self.slots, other.slots)
            and arr_eq(self.rows, other.rows)
        )


def _enc_arr(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    ds = a.dtype.str.encode()
    out = [struct.pack("<B", len(ds)), ds, struct.pack("<B", a.ndim)]
    out += [struct.pack("<q", s) for s in a.shape]
    out.append(a.tobytes())
    return b"".join(out)


def _dec_arr(buf: bytes, off: int) -> tuple[np.ndarray, int]:
    (dlen,) = struct.unpack_from("<B", buf, off)
    off += 1
    dtype = np.dtype(buf[off : off + dlen].decode())
    off += dlen
    (ndim,) = struct.unpack_from("<B", buf, off)
    off += 1
    shape = []
    for _ in range(ndim):
        (s,) = struct.unpack_from("<q", buf, off)
        off += 8
        shape.append(int(s))
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    nbytes = count * dtype.itemsize
    if off + nbytes > len(buf):
        raise ValueError("array payload truncated")
    a = np.frombuffer(buf[off : off + nbytes], dtype=dtype).reshape(shape)
    return a.copy(), off + nbytes


def _encode_payload(rec: WalRecord) -> bytes:
    code = _KIND_TO_CODE.get(rec.kind)
    if code is None:
        raise ValueError(f"unknown WAL record kind {rec.kind!r}")
    head = struct.pack("<BQ", code, rec.seq)
    if rec.kind == "insert":
        return head + _enc_arr(rec.keys) + _enc_arr(rec.slots) + _enc_arr(rec.rows)
    if rec.kind == "delete":
        return head + _enc_arr(rec.slots)
    return head + struct.pack("<qq", rec.capacity, rec.min_free)


def _decode_payload(payload: bytes) -> WalRecord:
    code, seq = struct.unpack_from("<BQ", payload, 0)
    off = struct.calcsize("<BQ")
    kind = _CODE_TO_KIND.get(code)
    if kind is None:
        raise ValueError(f"unknown WAL record code {code}")
    if kind == "insert":
        keys, off = _dec_arr(payload, off)
        slots, off = _dec_arr(payload, off)
        rows, off = _dec_arr(payload, off)
        return WalRecord(kind=kind, seq=int(seq), keys=keys, slots=slots, rows=rows)
    if kind == "delete":
        slots, off = _dec_arr(payload, off)
        return WalRecord(kind=kind, seq=int(seq), slots=slots)
    capacity, min_free = struct.unpack_from("<qq", payload, off)
    return WalRecord(kind=kind, seq=int(seq), capacity=int(capacity), min_free=int(min_free))


def encode_record(rec: WalRecord) -> bytes:
    """Frame one record: ``<u32 length><u32 crc32(payload)><payload>``."""
    payload = _encode_payload(rec)
    return struct.pack("<II", len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def decode_records(data: bytes, offset: int = 0) -> tuple[list[WalRecord], int]:
    """Decode framed records, tolerating a torn tail.

    Stops at the first incomplete frame, CRC mismatch or undecodable payload
    and returns ``(records, end_offset)``, ``end_offset`` being the byte
    boundary of the last valid record: everything after it is the torn tail
    a crashed writer left.
    """
    records: list[WalRecord] = []
    off = offset
    n = len(data)
    while True:
        if off + 8 > n:
            break
        length, crc = struct.unpack_from("<II", data, off)
        if off + 8 + length > n:
            break
        payload = data[off + 8 : off + 8 + length]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break
        try:
            rec = _decode_payload(payload)
        except Exception:
            break
        records.append(rec)
        off += 8 + length
    return records, off


# --------------------------------------------------------------------------
# Write-ahead log
# --------------------------------------------------------------------------


class WriteAheadLog:
    """Append-only, CRC-framed redo log with an fsync policy.

    ``append`` writes and flushes the frame (visible to the OS: it survives
    a process kill; only a host power loss can take it, and only under
    ``fsync != "always"`` before the next group commit).  Opening an
    existing log truncates a torn tail in place.

    Thread-safe: ``append`` / ``flush`` / ``truncate`` hold one lock (the
    group commit runs on the maintenance thread while the serving thread
    appends).
    """

    def __init__(self, path, *, fsync: str = "group", crash=None):
        if fsync not in ("always", "group", "off"):
            raise ValueError(f"fsync policy must be 'always', 'group' or 'off', got {fsync!r}")
        self.path = Path(path)
        self.fsync_policy = fsync
        self._crash = crash
        self._lock = threading.Lock()
        self.next_seq = 0
        self.appended_seq = -1  # last fully framed record
        self.synced_seq = -1  # last record covered by an fsync
        self._dirty = False
        self.torn_bytes_dropped = 0
        if self.path.exists() and self.path.stat().st_size > 0:
            records, valid, dropped = self.read(self.path)
            if valid == 0:
                # unreadable header: the whole file is torn, start over
                self.torn_bytes_dropped = dropped
                self._f = self._create()
            else:
                if dropped:
                    with open(self.path, "r+b") as f:
                        f.truncate(valid)
                    self.torn_bytes_dropped = dropped
                if records:
                    self.next_seq = records[-1].seq + 1
                    self.appended_seq = records[-1].seq
                    # what is framed on disk is this generation's durable baseline
                    self.synced_seq = records[-1].seq
                self._f = open(self.path, "ab")
        else:
            self._f = self._create()

    def _create(self):
        f = open(self.path, "wb")
        f.write(WAL_MAGIC)
        f.flush()
        os.fsync(f.fileno())  # one-time log creation
        return f

    # -- crash-point plumbing ------------------------------------------------

    def _reach(self, point: str) -> None:
        if self._crash is not None:
            self._crash.reach(point)

    def _armed(self, point: str) -> bool:
        return (
            self._crash is not None
            and getattr(self._crash, "armed", None) == point
            and not getattr(self._crash, "fired", False)
        )

    # -- logging -------------------------------------------------------------

    def append(self, rec: WalRecord) -> int:
        """Frame and flush one record; returns its ``seq``.

        Under ``fsync="always"`` the record is durable on storage before the
        return; under ``"group"`` the log is marked dirty for the next
        :meth:`flush`; under ``"off"`` the OS decides.
        """
        with self._lock:
            rec = dataclasses.replace(rec, seq=self.next_seq)
            buf = encode_record(rec)
            self._reach("wal.append.pre")
            if self._armed("wal.append.torn"):
                # a kill mid-frame: half the frame reaches the OS, then the
                # process dies; recovery must truncate it
                self._f.write(buf[: max(len(buf) // 2, 1)])
                self._f.flush()
                self._reach("wal.append.torn")
            self._f.write(buf)
            self._f.flush()
            self._reach("wal.append.post-write")
            self.next_seq = rec.seq + 1
            self.appended_seq = rec.seq
            if self.fsync_policy == "always":
                # per-record durability is this policy's explicit contract
                os.fsync(self._f.fileno())
                self.synced_seq = rec.seq
                self._reach("wal.fsync.post")
            elif self.fsync_policy == "group":
                self._dirty = True
            return rec.seq

    def flush(self) -> bool:
        """Group commit: fsync if a record was appended since the last one.
        Runs on the maintenance thread (or an explicit caller off the
        serving path)."""
        with self._lock:
            if not self._dirty:
                return False
            os.fsync(self._f.fileno())  # group commit, off the serving path
            self.synced_seq = self.appended_seq
            self._dirty = False
            self._reach("wal.fsync.post")
            return True

    def truncate(self, upto_seq: int) -> None:
        """Drop records with ``seq <= upto_seq`` (covered by a durable
        snapshot): the tail is written to a fresh file that replaces the log."""
        with self._lock:
            self._f.flush()
            records, _, _ = self.read(self.path)
            tail = [r for r in records if r.seq > upto_seq]
            tmp = self.path.with_name(self.path.name + ".tmp")
            with open(tmp, "wb") as f:
                f.write(WAL_MAGIC)
                for r in tail:
                    f.write(encode_record(r))
                f.flush()
                os.fsync(f.fileno())  # snapshot-time truncation, off the serving path
            self._reach("wal.truncate.post-write")
            self._f.close()
            os.replace(tmp, self.path)
            self._reach("wal.truncate.post-rename")
            self._f = open(self.path, "ab")
            self._dirty = False

    @staticmethod
    def read(path) -> tuple[list[WalRecord], int, int]:
        """Parse a log file -> ``(records, valid_bytes, dropped_bytes)``:
        ``valid_bytes`` ends the last whole record (header included),
        ``dropped_bytes`` is the torn tail beyond it.  A missing file is an
        empty log; an unreadable header drops the whole file."""
        path = Path(path)
        if not path.exists():
            return [], 0, 0
        data = path.read_bytes()
        if len(data) < len(WAL_MAGIC) or data[: len(WAL_MAGIC)] != WAL_MAGIC:
            return [], 0, len(data)
        records, end = decode_records(data, len(WAL_MAGIC))
        return records, end, len(data) - end

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


# --------------------------------------------------------------------------
# Maintenance thread: group-commit flush + async re-index prepare
# --------------------------------------------------------------------------


class MaintenanceWorker:
    """One daemon thread for the durable work that stays off the serving
    path: the group-commit flush (every ``interval_s`` while dirty) and
    submitted jobs (the asynchronous re-index prepare,
    :meth:`repro_torch.serve.mutation.MutationManager.reindex_async`).

    Jobs run one at a time in submission order, and no flush runs while a
    job does.  A job's exception is the job's (the re-index job keeps it for
    ``finish_reindex``); the thread itself never dies, so the flush cadence
    survives a failed re-cluster.
    """

    def __init__(self, flush: Callable[[], bool], interval_s: float = 0.010):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._flush = flush
        self._interval = float(interval_s)
        self._jobs: deque[Callable[[], None]] = deque()
        self._cond = threading.Condition()
        self._stop = False
        self.last_flush_error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="suco-durability", daemon=True)
        self._thread.start()

    def submit(self, fn: Callable[[], None]) -> None:
        with self._cond:
            if self._stop:
                raise RuntimeError("maintenance worker is stopped")
            self._jobs.append(fn)
            self._cond.notify()

    def stop(self, *, timeout: float = 5.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while True:
            fn = None
            with self._cond:
                if self._stop and not self._jobs:
                    break
            # flush outside the condition lock: fsync latency must not block submit()
            try:
                self._flush()
                self.last_flush_error = None
            except BaseException as e:  # noqa: BLE001 — the worker must survive
                self.last_flush_error = e
            with self._cond:
                if self._jobs:
                    fn = self._jobs.popleft()
                elif not self._stop:
                    self._cond.wait(timeout=self._interval)
                    if self._jobs:
                        fn = self._jobs.popleft()
            if fn is not None:
                # the re-index job keeps its own exception; a bare callable
                # that raises must not end the flush loop either
                try:
                    fn()
                except BaseException:  # noqa: BLE001
                    pass


# --------------------------------------------------------------------------
# Durability orchestration
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """Settings of one durability root.

    ``fsync``: ``"always"`` (per record, the serving path pays), ``"group"``
    (default: group commit on the maintenance thread every
    ``flush_interval_s``) or ``"off"`` (page cache only).  ``snapshot_keep``
    >= 2 keeps a fallback snapshot: the WAL is truncated only back to the
    oldest retained snapshot's high-water mark, so a corrupt newest
    snapshot still recovers with no acknowledged loss (a longer replay).
    """

    fsync: str = "group"
    flush_interval_s: float = 0.010
    snapshot_keep: int = 2
    snapshot_on_reindex: bool = True
    snapshot_on_swap: bool = True

    def __post_init__(self):
        if self.fsync not in ("always", "group", "off"):
            raise ValueError(
                f"fsync policy must be 'always', 'group' or 'off', got {self.fsync!r}"
            )
        if self.flush_interval_s <= 0:
            raise ValueError(f"flush_interval_s must be > 0, got {self.flush_interval_s}")
        if self.snapshot_keep < 1:
            raise ValueError(f"snapshot_keep must be >= 1, got {self.snapshot_keep}")


def _snapshot_covered(path: Path) -> int:
    """Records covered by a ``snapshot-NNN.npz`` file, from its name."""
    return int(path.name[len("snapshot-") : -len(".npz")])


class Durability:
    """The durability root: one WAL and rolling snapshots for one serving
    stack.  :meth:`attach` wires it; the server's mutation surface
    (``AnnServer.insert`` / ``delete`` / ``swap``) and the
    :class:`~repro_torch.serve.mutation.MutationManager` call the ``log_*``
    / ``note_swap`` hooks, which do nothing while ``replaying`` (recovery
    drives the same surface and must not log again).
    """

    def __init__(
        self,
        root,
        config: DurabilityConfig | None = None,
        *,
        crash=None,
        start_worker: bool | None = None,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.config = DurabilityConfig() if config is None else config
        self._crash = crash
        self.wal = WriteAheadLog(self.root / "wal.log", fsync=self.config.fsync, crash=crash)
        self.server: AnnServer | None = None
        self.manager = None
        self.replaying = False
        self._in_reindex = False
        if start_worker is None:
            start_worker = self.config.fsync == "group"
        self.worker = (
            MaintenanceWorker(self.wal.flush, self.config.flush_interval_s)
            if start_worker
            else None
        )

    # -- wiring --------------------------------------------------------------

    def attach(self, server: AnnServer, manager=None) -> "Durability":
        """Point the serving stack's durability hooks at this root."""
        self.server = server
        server.durability = self
        if manager is not None:
            self.manager = manager
            manager.durability = self
        return self

    def reach(self, point: str) -> None:
        """Crash-point hook for collaborators (the re-index prepare)."""
        if self._crash is not None:
            self._crash.reach(point)

    # -- logging hooks (called by AnnServer / MutationManager) ---------------

    def log_insert(self, rows, slots, *, keys=None) -> int | None:
        if self.replaying:
            return None
        # the port's engines hold float32 rows
        rows = np.atleast_2d(_host(rows)).astype(np.float32, copy=False)
        slots = np.atleast_1d(_host(slots)).astype(np.int64)
        keys = slots if keys is None else np.atleast_1d(_host(keys)).astype(np.int64)
        return self.wal.append(WalRecord(kind="insert", keys=keys, slots=slots, rows=rows))

    def log_delete(self, slots) -> int | None:
        if self.replaying:
            return None
        slots = np.atleast_1d(_host(slots)).astype(np.int64)
        return self.wal.append(WalRecord(kind="delete", slots=slots))

    def log_reindex(self, *, capacity: int, min_free: int = 0) -> int | None:
        """Log a committed re-index (its resolved capacity: a replay rebuilds
        the same successor), then checkpoint if configured: the re-cluster
        already paid a pass over the corpus, and the snapshot resets the
        replay horizon."""
        if self.replaying:
            return None
        seq = self.wal.append(
            WalRecord(kind="reindex", capacity=int(capacity), min_free=int(min_free))
        )
        if self.config.snapshot_on_reindex:
            self.snapshot()
        return seq

    def note_swap(self) -> None:
        """A bare ``server.swap`` installed an engine the WAL cannot replay:
        checkpoint at once.  A manager-driven re-index suppresses this (its
        ``reindex`` record replays it)."""
        if self.replaying or self._in_reindex:
            return
        if self.config.snapshot_on_swap:
            self.snapshot()

    def flush(self) -> bool:
        """Explicit group commit (tests, shutdown), off the serving path."""
        return self.wal.flush()

    # -- checkpointing -------------------------------------------------------

    def snapshot(self) -> Path:
        """Write an atomic, checksummed checkpoint and shrink the WAL.

        The artifact is written under a ``.writing`` name (itself atomically
        by ``SuCoIndex.save``), then ``os.replace``d onto its final
        ``snapshot-<records covered>.npz`` name: a kill in between leaves
        the old snapshot set intact or the new one whole, never a half
        file under a live name.  The WAL is truncated back to the oldest
        snapshot the root retains.
        """
        if self.server is None:
            raise ValueError("attach(server) before snapshot()")
        self.reach("snapshot.pre")
        hwm = self.wal.appended_seq
        extras = _collect_extras(self.server, self.manager, wal_seq=hwm)
        cfg = self.manager.config if self.manager is not None else None
        final = self.root / f"snapshot-{hwm + 1:012d}.npz"
        writing = self.root / (final.name + ".writing")
        self.server.engine.save(writing, cfg, extras=extras)
        self.reach("snapshot.post-write")
        os.replace(writing, final)
        self.reach("snapshot.post-rename")
        snaps = sorted(self.root.glob("snapshot-*.npz"), reverse=True)
        retained = snaps[: self.config.snapshot_keep]
        for old in snaps[self.config.snapshot_keep :]:
            old.unlink(missing_ok=True)
        # truncate only past what the OLDEST retained snapshot covers: if the
        # newest fails its checksums, the fallback and the longer tail still
        # hold every acknowledged record
        self.wal.truncate(min(_snapshot_covered(p) for p in retained) - 1)
        return final

    def close(self) -> None:
        """Orderly shutdown: final group commit, stop the worker, close."""
        if self.worker is not None:
            self.worker.stop()
            self.worker = None
        self.wal.flush()
        self.wal.close()

    def abandon(self) -> None:
        """Simulate process death (drills): drop everything without the final
        flush; what the OS has is what recovery gets."""
        if self.worker is not None:
            self.worker.stop(timeout=0.1)
            self.worker = None
        self.wal.close()


# --------------------------------------------------------------------------
# Serving-state sidecar (artifact-v3 extras)
# --------------------------------------------------------------------------

#: the JAX package's ``TileConfig`` carries its TPU grid tile (bm, bn) between
#: block_n and survivor_cap; the port writes its defaults there
_REF_TILE_BM, _REF_TILE_BN = 8, 512
#: the JAX package's kernel choices, which the port's policy does not carry
_REF_IMPL = "auto"


def _policy_extras(policy: EnginePolicy) -> dict[str, np.ndarray]:
    ex = {
        "policy_alpha": np.asarray(policy.alpha, np.float64),
        "policy_beta": np.asarray(policy.beta, np.float64),
        "policy_metric": np.asarray(policy.metric),
        "policy_mode": np.asarray(policy.mode),
        "policy_score_impl": np.asarray(_REF_IMPL),
        "policy_merge_impl": np.asarray(_REF_IMPL),
        "policy_block_n": np.asarray(policy.block_n, np.int64),
        "policy_batch_buckets": np.asarray(policy.batch_buckets, np.int64),
    }
    if policy.tiles is not None:
        t = policy.tiles
        ex["policy_tiles"] = np.asarray(
            [t.block_n, _REF_TILE_BM, _REF_TILE_BN, t.survivor_cap], np.int64
        )
    return ex


def _policy_from_extras(extras) -> EnginePolicy:
    """The policy of a sidecar of either package; the JAX package's kernel
    choices (``policy_score_impl`` / ``_merge_impl``) and TPU grid tile are
    read past."""
    kw = dict(
        alpha=float(extras["policy_alpha"][()]),
        beta=float(extras["policy_beta"][()]),
        metric=str(extras["policy_metric"][()]),
        mode=str(extras["policy_mode"][()]),
        block_n=int(extras["policy_block_n"][()]),
        batch_buckets=tuple(int(v) for v in extras["policy_batch_buckets"]),
    )
    if "policy_tiles" in extras:
        t = [int(v) for v in extras["policy_tiles"]]
        kw["tiles"] = TileConfig(block_n=t[0], survivor_cap=t[3])
    return EnginePolicy(**kw)


def _collect_extras(server: AnnServer, manager, *, wal_seq: int) -> dict:
    """The whole serving-state sidecar of one checkpoint."""
    e = server.engine
    next_slot = int(e._next_slot)
    capacity = e._capacity if e._capacity is not None else e.x.shape[0]
    extras: dict[str, np.ndarray] = {
        # Slots >= next_slot are zero padding by construction, and recovery
        # pads with zeros again: only the assigned rows leave the device.
        "x": e.x[:next_slot].cpu().numpy(),  # host-sync: ok — checkpoint gather, off the serving path
        "mutable": np.asarray(0 if e._capacity is None else 1, np.int64),
        "capacity": np.asarray(capacity, np.int64),
        "next_slot": np.asarray(next_slot, np.int64),
        "wal_seq": np.asarray(wal_seq, np.int64),
        "insert_inertia": np.asarray(e._insert_inertia.item(), np.float64),  # host-sync: ok — checkpoint scalar
        "inserted": np.asarray(e._inserted, np.int64),
    }
    extras.update(_policy_extras(e.policy))
    engines = server.ladder.engines if server.ladder is not None else [e]
    triples = sorted(
        {(lv, b, k) for lv, eng in enumerate(engines) for (b, k) in eng._buckets_seen}
    )
    extras["warm_triples"] = np.asarray(triples, np.int64).reshape(-1, 3)
    if server.ladder is not None:
        extras["ladder_levels"] = np.asarray(server.ladder.max_level, np.int64)
        extras["ladder_m_stat"] = np.asarray(server.ladder.m_stat, np.float64)
        extras["ladder_sigma_stat"] = np.asarray(server.ladder.sigma_stat, np.float64)
    if manager is not None:
        extras["mm_keys"] = np.asarray(manager._keys, np.int64)
        extras["mm_next_key"] = np.asarray(manager._next_key, np.int64)
        extras["mm_reindexes"] = np.asarray(manager.reindexes, np.int64)
        if manager.monitor._baseline is not None:
            extras["drift_baseline"] = np.asarray(manager.monitor._baseline, np.float64)
            extras["drift_baseline_inertia"] = np.asarray(
                manager.monitor._baseline_inertia, np.float64
            )
    return extras


def _rebuild_stack(
    index,
    cfg,
    extras,
    *,
    device,
    policy=None,
    config=None,
    server_cls=AnnServer,
    server_kwargs=None,
    manager_kwargs=None,
    durability=None,
):
    """``(engine, ladder, server, manager)`` from a loaded artifact and its
    sidecar, on ``device``.  Shared by :func:`recover` and
    :func:`load_serving_stack`."""
    pol = policy if policy is not None else _policy_from_extras(extras)
    capacity = int(extras["capacity"][()])
    next_slot = int(extras["next_slot"][()])
    mutable = bool(int(extras.get("mutable", np.asarray(1))[()]))
    x_part = np.asarray(extras["x"])
    x_full = np.zeros((capacity, x_part.shape[1]), dtype=x_part.dtype)
    x_full[: len(x_part)] = x_part
    engine = SuCoEngine(
        x_full, index, pol, capacity=capacity if mutable else None, device=device
    )
    engine._next_slot = next_slot
    engine._insert_inertia = torch.tensor(
        float(extras["insert_inertia"][()]), dtype=torch.float32, device=engine.device
    )
    engine._inserted = int(extras["inserted"][()])
    ladder = None
    if "ladder_levels" in extras:
        ladder = DegradationLadder(
            engine,
            levels=int(extras["ladder_levels"][()]),
            stats=(float(extras["ladder_m_stat"][()]), float(extras["ladder_sigma_stat"][()])),
        )
        ladder.rebind()
    server = server_cls(engine, ladder=ladder, durability=durability, **(server_kwargs or {}))
    manager = None
    if "mm_keys" in extras:
        mcfg = config if config is not None else cfg
        if mcfg is None:
            raise RecoveryError(
                "snapshot carries a MutationManager key table but no build "
                "config — pass config=SuCoConfig(...) to rebuild the manager"
            )
        from repro_torch.serve.mutation import MutationManager  # lazy: avoid a cycle

        manager = MutationManager(server, mcfg, **(manager_kwargs or {}))
        manager._keys = np.asarray(extras["mm_keys"], np.int64).copy()
        manager._next_key = int(extras["mm_next_key"][()])
        manager.reindexes = int(extras.get("mm_reindexes", np.asarray(0))[()])
        if "drift_baseline" in extras:
            manager.monitor._baseline = np.asarray(extras["drift_baseline"], np.float64).copy()
            manager.monitor._baseline_inertia = float(extras["drift_baseline_inertia"][()])
    return engine, ladder, server, manager


def _warm_from_extras(server: AnnServer, extras) -> int:
    """Warm exactly the recorded ``(level, bucket, k)`` surface; returns the
    new pairs.  After it, the recovered stack serves the pre-crash mix
    without meeting a new pair."""
    warmed = 0
    triples = np.asarray(
        extras.get("warm_triples", np.zeros((0, 3), np.int64)), np.int64
    ).reshape(-1, 3)
    for lv, b, k in triples:
        eng = server.ladder.engine_for(int(lv)) if server.ladder is not None else server.engine
        warmed += eng.warmup([int(b)], [int(k)])
    return warmed


# --------------------------------------------------------------------------
# Plain save / load (keys survive without a WAL)
# --------------------------------------------------------------------------


def save_stack(path, server: AnnServer, manager=None, *, config=None) -> None:
    """One-shot durable save of a serving stack (no WAL): the version-3
    artifact with the whole sidecar, external keys included, written
    atomically.  :func:`load_serving_stack` reads it."""
    extras = _collect_extras(server, manager, wal_seq=-1)
    if config is None and manager is not None:
        config = manager.config
    server.engine.save(path, config, extras=extras)


def load_serving_stack(
    path,
    *,
    device: torch.device | str = "cuda",
    policy=None,
    config=None,
    server_cls=AnnServer,
    server_kwargs=None,
    manager_kwargs=None,
    warm: bool = True,
):
    """``(server, manager)`` on ``device`` from a :func:`save_stack` artifact
    or any snapshot, of either package.  ``manager`` is ``None`` when the
    artifact carries no key table."""
    index, cfg, extras = load_index_artifact(path, device=device, return_extras=True)
    if "x" not in extras:
        raise ArtifactError(
            f"{path!s}: artifact has no serving-state sidecar (extra_x) — "
            "write it with save_stack()/Durability.snapshot(), not the bare "
            "SuCoIndex.save()"
        )
    _, _, server, manager = _rebuild_stack(
        index,
        cfg,
        extras,
        device=device,
        policy=policy,
        config=config,
        server_cls=server_cls,
        server_kwargs=server_kwargs,
        manager_kwargs=manager_kwargs,
    )
    if warm:
        _warm_from_extras(server, extras)
    return server, manager


# --------------------------------------------------------------------------
# Recovery
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """What one :func:`recover` did."""

    snapshot_path: str
    snapshot_records: int  # mutation records the loaded snapshot covers
    snapshots_skipped: int  # corrupt newer snapshots fallen past
    wal_records: int  # valid records in the log
    replayed: int  # records past the snapshot's high-water mark
    dropped_bytes: int  # torn tail truncated
    warmed: int  # (bucket, k) pairs warmed from the recorded surface

    @property
    def applied_records(self) -> int:
        """Mutation records reflected in the recovered state."""
        return self.snapshot_records + self.replayed


@dataclasses.dataclass(frozen=True, eq=False)
class RecoveryResult:
    server: AnnServer
    manager: object
    durability: Durability
    report: RecoveryReport


def _apply_record(server: AnnServer, manager, rec: WalRecord) -> None:
    """Replay one record through the real mutation surface (deterministic,
    so the rebuilt state is bit-identical to the original apply)."""
    if rec.kind == "insert":
        got = np.asarray(server.insert(np.asarray(rec.rows)), np.int64)
        if rec.slots is not None and not np.array_equal(got, rec.slots):
            heads = got[:4].tolist(), rec.slots[:4].tolist()  # host-sync: ok — host arrays
            raise RecoveryError(
                f"replay diverged on insert seq={rec.seq}: engine assigned "
                f"slots starting {heads[0]}, log recorded {heads[1]}"
            )
        if manager is not None and rec.keys is not None:
            manager._keys = np.concatenate([manager._keys, rec.keys])
            if len(rec.keys):
                manager._next_key = max(manager._next_key, int(rec.keys.max()) + 1)
    elif rec.kind == "delete":
        server.delete(rec.slots)
    elif rec.kind == "reindex":
        if manager is None:
            raise RecoveryError(
                f"reindex record seq={rec.seq} needs a MutationManager, but "
                "the snapshot carries no key table"
            )
        manager.reindex(capacity=rec.capacity, min_free=rec.min_free)
    else:  # pragma: no cover — decode_records rejects unknown kinds
        raise RecoveryError(f"unknown WAL record kind {rec.kind!r}")


def recover(
    root,
    *,
    device: torch.device | str = "cuda",
    policy=None,
    config=None,
    durability_config: DurabilityConfig | None = None,
    server_cls=AnnServer,
    server_kwargs=None,
    manager_kwargs=None,
    crash=None,
    start_worker: bool | None = None,
) -> RecoveryResult:
    """Rebuild a serving stack on ``device`` from a durability root after a
    crash (``docs/durability.md``):

    1. delete stray partials (``*.writing`` / ``*.tmp``: staging files of
       an atomic rename a kill left, never a live name);
    2. load the newest snapshot whose checksums verify, falling back past
       corrupt ones (``snapshots_skipped``);
    3. open the WAL, its torn tail truncated at the first bad frame (never
       behind an acknowledged record, which is fully framed before the ack);
    4. rebuild engine / ladder / server / manager from the sidecar, replay
       every record past the snapshot's high-water mark through the real
       mutation surface, and warm the recorded surface again.

    The stack comes back attached to a fresh :class:`Durability` over the
    same root, continuing the same WAL.
    """
    root = Path(root)
    if not root.is_dir():
        raise RecoveryError(f"{root!s} is not a durability root")
    for stray in list(root.glob("*.writing")) + list(root.glob("*.tmp")):
        stray.unlink(missing_ok=True)
    snaps = sorted(root.glob("snapshot-*.npz"), reverse=True)
    skipped = 0
    loaded = None
    for p in snaps:
        try:
            index, cfg, extras = load_index_artifact(p, device=device, return_extras=True)
        except ArtifactError:
            skipped += 1
            continue
        if "x" not in extras or "wal_seq" not in extras:
            skipped += 1
            continue
        loaded = (p, index, cfg, extras)
        break
    if loaded is None:
        raise RecoveryError(
            f"no valid snapshot under {root!s} "
            f"({len(snaps)} candidates, {skipped} corrupt or sidecar-free)"
        )
    p, index, cfg, extras = loaded
    hwm = int(extras["wal_seq"][()])
    dur = Durability(root, durability_config, crash=crash, start_worker=start_worker)
    dur.wal.next_seq = max(dur.wal.next_seq, hwm + 1)
    records, _, _ = WriteAheadLog.read(root / "wal.log")
    tail = [r for r in records if r.seq > hwm]
    _, ladder, server, manager = _rebuild_stack(
        index,
        cfg,
        extras,
        device=device,
        policy=policy,
        config=config,
        server_cls=server_cls,
        server_kwargs=server_kwargs,
        manager_kwargs=manager_kwargs,
        durability=dur,
    )
    dur.attach(server, manager)
    dur.replaying = True
    try:
        for rec in tail:
            _apply_record(server, manager, rec)
    finally:
        dur.replaying = False
    warmed = _warm_from_extras(server, extras)
    if ladder is not None:
        ladder.rebind()
    report = RecoveryReport(
        snapshot_path=str(p),
        snapshot_records=hwm + 1,
        snapshots_skipped=skipped,
        wal_records=len(records),
        replayed=len(tail),
        dropped_bytes=dur.wal.torn_bytes_dropped,
        warmed=warmed,
    )
    return RecoveryResult(server=server, manager=manager, durability=dur, report=report)


# --------------------------------------------------------------------------
# Bit-identity fingerprints (the drill's comparison unit)
# --------------------------------------------------------------------------


def state_fingerprint(server: AnnServer, manager=None) -> dict[str, np.ndarray]:
    """Every array that defines the serving state, as host copies: two
    stacks serve identical answers iff their fingerprints are equal."""
    e = server.engine
    idx = e.index
    fp = {
        "x": e.x.cpu().numpy(),  # host-sync: ok — offline fingerprint gather
        "cell_ids": idx.cell_ids.cpu().numpy(),  # host-sync: ok — offline fingerprint gather
        "cell_counts": idx.cell_counts.cpu().numpy(),  # host-sync: ok — offline fingerprint gather
        "centroids1": idx.centroids1.cpu().numpy(),  # host-sync: ok — offline fingerprint gather
        "centroids2": idx.centroids2.cpu().numpy(),  # host-sync: ok — offline fingerprint gather
        "tombstone": (
            idx.tombstone.cpu().numpy()  # host-sync: ok — offline fingerprint gather
            if idx.tombstone is not None
            else np.zeros(0, bool)
        ),
        "next_slot": np.asarray(int(e._next_slot), np.int64),
        "capacity": np.asarray(-1 if e._capacity is None else int(e._capacity), np.int64),
        "n_live": np.asarray(int(e.n_live), np.int64),
    }
    if manager is not None:
        fp["keys"] = np.asarray(manager._keys, np.int64).copy()
        fp["next_key"] = np.asarray(int(manager._next_key), np.int64)
    return fp


def fingerprint_diff(a: dict, b: dict) -> tuple[str, ...]:
    """Names of fingerprint entries that differ (empty = bit-identical)."""
    names = sorted(set(a) | set(b))
    return tuple(
        n for n in names if n not in a or n not in b or not np.array_equal(a[n], b[n])
    )
