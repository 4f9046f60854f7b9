"""The port's durability layer (``repro_torch.serve.durability``) against the
JAX package's (``repro.serve.durability``), on the CPU.

* WAL frames: the same records encode to the same bytes in both packages,
  and each package decodes the other's frames and log files (hypothesis
  over kinds, shapes and dtypes); the same torn tail drops the same bytes.
* Snapshots: a ``save_stack`` artifact of either package loads in the
  other's ``load_serving_stack`` with keys, policy (pinned tiles too: the
  JAX package's ``[block_n, bm, bn, survivor_cap]``), warm triples, ladder
  statistics and every fingerprint array equal; the sidecar carries the same
  names.
* Recovery: a root either package wrote (a snapshot, then insert and delete
  records) recovers in the other to the writer's ``x``, ``cell_ids``,
  ``cell_counts``, ``tombstone`` and keys exactly (integer points and
  centroids, so every insert's assignment is exact in both arithmetics).
* Drills: the port's ``recovery_drill`` at all ten crash points under both
  fsync policies is bit-identical, and its host-determined fields equal the
  JAX package's drill at ``wal.append.torn``, ``snapshot.post-write``,
  ``wal.truncate.post-rename`` and ``reindex.mid-prepare``.

Every comparison here is exact (tolerance 0), except answers of a loaded
stack, held with ids equal except at fp ties (rtol 2e-5).
"""

import dataclasses
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core import suco as jsuco
from repro.core.tuning import TileConfig as JTiles
from repro.serve import ann as jann
from repro.serve import chaos as jchaos
from repro.serve import durability as jdur
from repro.serve import mutation as jmut

from repro_torch.core import suco as psuco
from repro_torch.core.tuning import TileConfig as PTiles
from repro_torch.data import gaussian_mixture, make_dataset
from repro_torch.serve import ann as pann
from repro_torch.serve import chaos as pchaos
from repro_torch.serve import durability as pdur
from repro_torch.serve import mutation as pmut

K = 5

# ---------------------------------------------------------------------------
# WAL frames
# ---------------------------------------------------------------------------

ROW_DTYPES = (np.float32, np.float64, np.int32, np.float16)


def _records(seed: int, n: int, dtype_i: int) -> list[dict]:
    """``n`` random records as field dicts (kinds, shapes and dtypes drawn)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = ("insert", "delete", "reindex")[int(rng.integers(0, 3))]
        seq = int(rng.integers(0, 1 << 50))
        if kind == "insert":
            b, d = int(rng.integers(0, 6)), int(rng.integers(1, 9))
            rows = (rng.standard_normal((b, d)) * 100).astype(ROW_DTYPES[dtype_i])
            out.append(dict(kind=kind, seq=seq, rows=rows,
                            keys=rng.integers(0, 1 << 40, size=b).astype(np.int64),
                            slots=rng.integers(0, 1 << 20, size=b).astype(np.int64)))
        elif kind == "delete":
            out.append(dict(kind=kind, seq=seq,
                            slots=rng.integers(0, 1 << 20, size=int(rng.integers(0, 8)))
                            .astype(np.int64)))
        else:
            out.append(dict(kind=kind, seq=seq, capacity=int(rng.integers(1, 1 << 30)),
                            min_free=int(rng.integers(0, 1 << 10))))
    return out


def _fields(rec) -> dict:
    return {f: getattr(rec, f) for f in ("kind", "seq", "keys", "slots", "rows", "capacity",
                                          "min_free")}


def _assert_same_record(got, want):
    a, b = _fields(got), _fields(want)
    for f in a:
        if isinstance(b[f], np.ndarray) or isinstance(a[f], np.ndarray):
            assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        else:
            assert a[f] == b[f], f


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=100_000),
       n=st.integers(min_value=1, max_value=5),
       dtype_i=st.integers(min_value=0, max_value=len(ROW_DTYPES) - 1))
def test_wal_frames_are_byte_equal_and_cross_decode(seed, n, dtype_i):
    recs = _records(seed, n, dtype_i)
    want = b"".join(jdur.encode_record(jdur.WalRecord(**r)) for r in recs)
    got = b"".join(pdur.encode_record(pdur.WalRecord(**r)) for r in recs)
    assert got == want
    from_ref, end = pdur.decode_records(want)
    assert end == len(want) and len(from_ref) == n
    from_port, end = jdur.decode_records(got)
    assert end == len(got) and len(from_port) == n
    for r, a, b in zip(recs, from_ref, from_port):
        _assert_same_record(a, b)
        assert a == pdur.WalRecord(**r)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=100_000),
       n=st.integers(min_value=0, max_value=6),
       cut_frac=st.floats(min_value=0.0, max_value=1.0))
def test_torn_tail_drops_the_same_bytes(seed, n, cut_frac, tmp_path_factory):
    """A log cut at any byte: both packages keep the same records, report
    the same valid and dropped bytes, and truncate the file to the same
    length on open."""
    recs = _records(seed, n, 0)
    data = jdur.WAL_MAGIC + b"".join(jdur.encode_record(jdur.WalRecord(**r)) for r in recs)
    cut = int(round(cut_frac * len(data)))
    d = tmp_path_factory.mktemp("torn")
    paths = {}
    for name in ("ref", "port"):
        paths[name] = d / f"{name}.log"
        paths[name].write_bytes(data[:cut])
    want_recs, want_valid, want_dropped = jdur.WriteAheadLog.read(paths["ref"])
    got_recs, got_valid, got_dropped = pdur.WriteAheadLog.read(paths["port"])
    assert (got_valid, got_dropped) == (want_valid, want_dropped)
    assert len(got_recs) == len(want_recs)
    for a, b in zip(got_recs, want_recs):
        _assert_same_record(a, b)
    if cut:
        jw = jdur.WriteAheadLog(paths["ref"], fsync="off")
        pw = pdur.WriteAheadLog(paths["port"], fsync="off")
        assert (pw.torn_bytes_dropped, pw.next_seq, pw.appended_seq, pw.synced_seq) == (
            jw.torn_bytes_dropped, jw.next_seq, jw.appended_seq, jw.synced_seq)
        jw.close()
        pw.close()
        assert paths["port"].read_bytes() == paths["ref"].read_bytes()


def test_each_package_appends_to_the_others_log(tmp_path):
    """A log one package wrote is continued by the other: the same sequence
    numbers and, byte for byte, the same file as one package alone."""
    recs = [dict(kind="delete", slots=np.asarray([i, i + 7], np.int64)) for i in range(3)]
    recs.append(dict(kind="insert", keys=np.asarray([5], np.int64),
                     slots=np.asarray([9], np.int64), rows=np.ones((1, 4), np.float32)))
    recs.append(dict(kind="reindex", capacity=1234, min_free=5))
    logs = {}
    for first, second in ((jdur, pdur), (pdur, jdur), (jdur, jdur)):
        path = tmp_path / f"{first.__name__}-{second.__name__}.log"
        w = first.WriteAheadLog(path, fsync="always")
        seqs = [w.append(first.WalRecord(**r)) for r in recs[:2]]
        w.close()
        w = second.WriteAheadLog(path, fsync="group")
        seqs += [w.append(second.WalRecord(**r)) for r in recs[2:]]
        assert w.flush() and w.synced_seq == 4
        w.truncate(1)
        w.close()
        assert seqs == [0, 1, 2, 3, 4]
        logs[path.name] = path.read_bytes()
    assert len(set(logs.values())) == 1


def test_wal_and_config_validation_is_the_references(tmp_path):
    for mod in (jdur, pdur):
        with pytest.raises(ValueError, match="fsync policy"):
            mod.WriteAheadLog(tmp_path / "w.log", fsync="sometimes")
        with pytest.raises(ValueError, match="fsync policy"):
            mod.DurabilityConfig(fsync="sometimes")
        with pytest.raises(ValueError, match="flush_interval_s"):
            mod.DurabilityConfig(flush_interval_s=0.0)
        with pytest.raises(ValueError, match="snapshot_keep"):
            mod.DurabilityConfig(snapshot_keep=0)
        with pytest.raises(ValueError, match="unknown WAL record kind"):
            mod.encode_record(mod.WalRecord(kind="upsert"))


# ---------------------------------------------------------------------------
# Stacks over one integer index, in both packages
# ---------------------------------------------------------------------------

N, D = 600, 16
CFG = dict(n_subspaces=4, sqrt_k=8, kmeans_iters=2, seed=0)


@pytest.fixture(scope="module")
def shared():
    """Integer points and a JAX index over them with integer centroids; the
    same index in the port; integer rows to insert."""
    x = np.round(gaussian_mixture(N, D, 0, spread=3.0))
    jidx = jsuco.build_index(jnp.asarray(x), jsuco.SuCoConfig(**CFG))
    jidx = dataclasses.replace(jidx, centroids1=jnp.round(jidx.centroids1),
                               centroids2=jnp.round(jidx.centroids2))
    pidx = psuco.SuCoIndex.from_numpy(
        *(np.asarray(a) for a in (jidx.centroids1, jidx.centroids2, jidx.cell_ids,
                                  jidx.cell_counts)),
        spec=psuco.sub.SubspaceSpec(D, 4, jidx.spec.perm, jidx.spec.bounds), sqrt_k=8,
        device="cpu")
    new = np.round(gaussian_mixture(60, D, 7, spread=3.0))
    return SimpleNamespace(x=x, jidx=jidx, pidx=pidx, new=new)


REF = SimpleNamespace(name="ref", suco=jsuco, ann=jann, mut=jmut, dur=jdur, chaos=jchaos,
                      tiles=JTiles)
PORT = SimpleNamespace(name="port", suco=psuco, ann=pann, mut=pmut, dur=pdur, chaos=pchaos,
                       tiles=PTiles)


def _engine(side, shared, policy):
    if side is REF:
        return jsuco.SuCoEngine(jnp.asarray(shared.x), shared.jidx, policy, capacity=N + 200)
    return psuco.SuCoEngine(shared.x, shared.pidx, policy, capacity=N + 200, device="cpu")


def _stack(side, shared, root=None, *, tiles=None, fsync="group", start_worker=False):
    policy = side.suco.EnginePolicy(alpha=0.1, beta=0.05, batch_buckets=(1, 4, 16),
                                    tiles=tiles)
    engine = _engine(side, shared, policy)
    ladder = side.ann.DegradationLadder(engine, levels=1, stats_seed=0)
    server = side.ann.AnnServer(engine, ladder=ladder, max_batch=4)
    ladder.warmup([1], [K])
    manager = side.mut.MutationManager(server, side.suco.SuCoConfig(**CFG), stats_seed=0)
    dur = None
    if root is not None:
        dur = side.dur.Durability(root, side.dur.DurabilityConfig(fsync=fsync),
                                  start_worker=start_worker).attach(server, manager)
    return server, manager, dur


def _mutate(manager, shared):
    manager.insert(shared.new[:20])
    manager.delete(np.asarray([0, 1, 2, 605, 33], np.int64))
    manager.insert(shared.new[20:45])
    manager.delete(np.asarray([610, 40], np.int64))


def _fingerprints_equal(a, b):
    assert set(a) == set(b)
    diff = [n for n in a if not (a[n].dtype == b[n].dtype and np.array_equal(a[n], b[n]))]
    assert not diff, diff


def _host_fp(side, server, manager):
    return {k: np.asarray(v) for k, v in side.dur.state_fingerprint(server, manager).items()}


@pytest.mark.parametrize("tiles", [None, (512, 128)])
@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref_to_port", "port_to_ref"])
def test_snapshot_loads_in_the_other_package(shared, tmp_path, writer, reader, tiles):
    tile_cfg = None
    if tiles is not None:
        tile_cfg = (JTiles(block_n=tiles[0], bm=16, bn=256, survivor_cap=tiles[1])
                    if writer is REF else PTiles(block_n=tiles[0], survivor_cap=tiles[1]))
    server, manager, _ = _stack(writer, shared, tiles=tile_cfg)
    _mutate(manager, shared)
    q = shared.new[45:49] + 0.5
    want_ans = server.engine.query(q, k=K)
    server.engine.query(q[:2], k=3)  # another warm pair: (4, 3)
    path = tmp_path / "stack.npz"
    manager.save(path)
    if reader is PORT:
        got_server, got_manager = pdur.load_serving_stack(path, device="cpu")
    else:
        got_server, got_manager = jdur.load_serving_stack(path)
    # keys, counters and the drift baseline
    np.testing.assert_array_equal(got_manager._keys, manager._keys)
    assert (got_manager._next_key, got_manager.reindexes) == (manager._next_key,
                                                              manager.reindexes)
    np.testing.assert_array_equal(got_manager.monitor._baseline, manager.monitor._baseline)
    assert got_manager.monitor._baseline_inertia == manager.monitor._baseline_inertia
    # the policy, pinned tiles read across the two TileConfigs
    gp, wp = got_server.engine.policy, server.engine.policy
    assert (gp.alpha, gp.beta, gp.metric, gp.mode, gp.block_n, gp.batch_buckets) == (
        wp.alpha, wp.beta, wp.metric, wp.mode, wp.block_n, wp.batch_buckets)
    if tiles is None:
        assert gp.tiles is None
    else:
        assert (gp.tiles.block_n, gp.tiles.survivor_cap) == tiles
        if reader is REF:  # the port writes the JAX package's grid-tile defaults
            assert (gp.tiles.bm, gp.tiles.bn) == (8, 512)
    with np.load(path) as z:
        if tiles is not None:
            bm_bn = (16, 256) if writer is REF else (8, 512)
            np.testing.assert_array_equal(z["extra_policy_tiles"],
                                          [tiles[0], *bm_bn, tiles[1]])
        assert str(z["extra_policy_score_impl"][()]) == "auto"
    # warm triples and ladder statistics
    assert [sorted(e._buckets_seen) for e in got_server.ladder.engines] == [
        sorted(e._buckets_seen) for e in server.ladder.engines]
    assert (got_server.ladder.max_level, got_server.ladder.m_stat, got_server.ladder.sigma_stat) \
        == (server.ladder.max_level, server.ladder.m_stat, server.ladder.sigma_stat)
    _fingerprints_equal(_host_fp(reader, got_server, got_manager),
                        _host_fp(writer, server, manager))
    # the loaded stack answers as the writer did, with no new pair
    exe = got_server.executables
    got_ans = got_server.engine.query(q, k=K)
    assert got_server.executables == exe
    want_ids, want_d = np.asarray(want_ans.ids), np.asarray(want_ans.dists)
    got_ids, got_d = np.asarray(got_ans.ids), np.asarray(got_ans.dists)
    np.testing.assert_allclose(got_d, want_d, rtol=2e-5)
    for c in zip(*np.nonzero(got_ids != want_ids)):
        assert (np.abs(want_d[c[0]] - want_d[c]) <= 2e-5 * want_d[c]).sum() > 1, c


def test_sidecars_carry_the_same_names(shared, tmp_path):
    names = {}
    for side in (REF, PORT):
        server, manager, _ = _stack(side, shared, tiles=side.tiles(block_n=256))
        _mutate(manager, shared)
        manager.save(tmp_path / f"{side.name}.npz")
        with np.load(tmp_path / f"{side.name}.npz") as z:
            names[side.name] = set(z.files)
    assert names["port"] == names["ref"]


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref_to_port", "port_to_ref"])
def test_recover_a_root_the_other_package_wrote(shared, tmp_path, writer, reader):
    root = tmp_path / "root"
    server, manager, dur = _stack(writer, shared, root)
    dur.snapshot()
    _mutate(manager, shared)
    dur.abandon()
    want = _host_fp(writer, server, manager)
    if reader is PORT:
        res = pdur.recover(root, device="cpu", start_worker=False)
    else:
        res = jdur.recover(root, start_worker=False)
    assert res.report.replayed == 4 and res.report.snapshot_records == 0
    _fingerprints_equal(_host_fp(reader, res.server, res.manager), want)
    assert res.manager._next_key == manager._next_key
    res.durability.close()


# ---------------------------------------------------------------------------
# The port's own recovery behaviour (the reference's cases)
# ---------------------------------------------------------------------------


def test_recover_requires_a_snapshot_and_rejects_bare_artifacts(shared, tmp_path):
    (tmp_path / "root").mkdir()
    with pytest.raises(pdur.RecoveryError, match="no valid snapshot"):
        pdur.recover(tmp_path / "root", device="cpu", start_worker=False)
    with pytest.raises(pdur.RecoveryError, match="not a durability root"):
        pdur.recover(tmp_path / "nope", device="cpu", start_worker=False)
    shared.pidx.save(tmp_path / "bare.npz", psuco.SuCoConfig(**CFG))
    with pytest.raises(psuco.ArtifactError, match="sidecar"):
        pdur.load_serving_stack(tmp_path / "bare.npz", device="cpu")


def test_recover_falls_back_past_a_corrupt_newest_snapshot(shared, tmp_path):
    root = tmp_path / "root"
    server, manager, dur = _stack(PORT, shared, root)
    manager.insert(shared.new[:3])
    dur.snapshot()
    manager.delete(np.asarray([1, 2], np.int64))
    dur.snapshot()
    dur.abandon()
    snaps = sorted(root.glob("snapshot-*.npz"))
    assert len(snaps) == 2
    snaps[-1].write_bytes(snaps[-1].read_bytes()[:200])
    res = pdur.recover(root, device="cpu", start_worker=False)
    assert res.report.snapshots_skipped == 1 and res.report.snapshot_path == str(snaps[0])
    assert res.report.replayed >= 1
    _fingerprints_equal(_host_fp(PORT, res.server, res.manager),
                        _host_fp(PORT, server, manager))
    # the recovered stack keeps logging and recovers again
    res.manager.insert(shared.new[3:5])
    res.manager.delete(np.asarray([5], np.int64))
    res.durability.abandon()
    res2 = pdur.recover(root, device="cpu", start_worker=False)
    _fingerprints_equal(_host_fp(PORT, res2.server, res2.manager),
                        _host_fp(PORT, res.server, res.manager))
    res2.durability.close()


def test_bare_swap_checkpoints_and_recovers(shared, tmp_path):
    root = tmp_path / "root"
    server, manager, dur = _stack(PORT, shared, root)
    x2 = torch.from_numpy(shared.x[:400])
    succ = psuco.SuCoEngine(x2, psuco.build_index(x2, psuco.SuCoConfig(**CFG)),
                            psuco.EnginePolicy(alpha=0.1, beta=0.05, batch_buckets=(1, 4, 16)),
                            capacity=600, device="cpu")
    ladder2 = pann.DegradationLadder(succ, levels=1, stats_seed=0)
    for old_e, new_e in zip(server.ladder.engines, ladder2.engines):
        pmut.warm_like(new_e, old_e)
    server.swap(succ, ladder=ladder2)
    assert len(list(root.glob("snapshot-*.npz"))) == 1
    dur.abandon()
    res = pdur.recover(root, device="cpu", start_worker=False)
    _fingerprints_equal(_host_fp(PORT, res.server, res.manager),
                        _host_fp(PORT, server, manager))
    res.durability.close()


def test_reindex_async_on_the_maintenance_worker(shared, tmp_path):
    """With the group-commit worker running, the prepare runs on it; the
    commit logs a ``reindex`` record and snapshots; the root recovers to the
    committed successor and a later insert bit for bit."""
    root = tmp_path / "root"
    server, manager, dur = _stack(PORT, shared, root, start_worker=True)
    seen = {}
    real = pmut.build_index

    def spy(x, config, **kw):
        seen["thread"] = threading.current_thread().name
        return real(x, config, **kw)

    dur.snapshot()
    manager.insert(shared.new[:10])
    pmut.build_index = spy
    try:
        manager.reindex_async()
        manager.finish_reindex(timeout=300)
    finally:
        pmut.build_index = real
    assert seen["thread"] == "suco-durability"
    records, _, _ = pdur.WriteAheadLog.read(root / "wal.log")
    snaps = sorted(root.glob("snapshot-*.npz"))
    assert snaps[-1].name == f"snapshot-{2:012d}.npz"  # insert + reindex covered
    assert [r.kind for r in records] == ["insert", "reindex"]  # kept for the fallback
    manager.insert(shared.new[10:12])
    dur.abandon()
    res = pdur.recover(root, device="cpu", start_worker=False)
    assert res.report.replayed == 1
    _fingerprints_equal(_host_fp(PORT, res.server, res.manager),
                        _host_fp(PORT, server, manager))
    res.durability.close()


# ---------------------------------------------------------------------------
# The crash-drill sweep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drill_ds():
    """The reference sweep's data set (``tests/test_durability.py``)."""
    return make_dataset("gaussian_mixture", 500, 16, m=10, k=5, seed=0)


def _drill_build(side, ds, fsync):
    cfg = side.suco.SuCoConfig(n_subspaces=4, sqrt_k=8, kmeans_iters=2, seed=0)

    def build(root, injector):
        if side is REF:
            x = jnp.asarray(ds.x)
            engine = jsuco.SuCoEngine(x, jsuco.build_index(x, cfg),
                                      jsuco.EnginePolicy(alpha=0.1, beta=0.05), capacity=700)
        else:
            x = torch.from_numpy(ds.x)
            engine = psuco.SuCoEngine(x, psuco.build_index(x, cfg),
                                      psuco.EnginePolicy(alpha=0.1, beta=0.05), capacity=700,
                                      device="cpu")
        ladder = side.ann.DegradationLadder(engine, levels=1, stats_seed=0)
        server = side.ann.AnnServer(engine, ladder=ladder)
        ladder.warmup([1], [K])
        manager = side.mut.MutationManager(server, cfg, stats_seed=0)
        dur = side.dur.Durability(root, side.dur.DurabilityConfig(fsync=fsync), crash=injector,
                                  start_worker=False).attach(server, manager)
        return server, manager, dur

    return build


def _drill(side, ds, root, point, fsync):
    return side.chaos.recovery_drill(root, _drill_build(side, ds, fsync),
                                     side.chaos.drill_steps(16, seed=3), point,
                                     queries=ds.x[:4], k=K)


@pytest.mark.parametrize("fsync", ["always", "group"])
@pytest.mark.parametrize("point", pchaos.CRASH_POINTS)
def test_recovery_drill_sweep(drill_ds, tmp_path, point, fsync):
    rep = _drill(PORT, drill_ds, tmp_path, point, fsync)
    assert rep.crash_point == point
    assert rep.fired, f"{point} was never reached by the drill script"
    assert rep.lost_acked == 0, rep
    assert rep.bit_identical, rep.fingerprint_diff
    assert rep.retraces_after_warmup == 0, rep
    assert rep.answers_match, rep
    assert rep.quality_bounds_match, rep


HOST_FIELDS = ("fired", "acked", "applied", "lost_acked", "dropped_bytes", "snapshots_skipped")


@pytest.mark.parametrize("fsync", ["always", "group"])
@pytest.mark.parametrize("point", ["wal.append.torn", "snapshot.post-write",
                                   "wal.truncate.post-rename", "reindex.mid-prepare"])
def test_drill_host_fields_match_reference(drill_ds, tmp_path, point, fsync):
    want = _drill(REF, drill_ds, tmp_path / "ref", point, fsync)
    got = _drill(PORT, drill_ds, tmp_path / "port", point, fsync)
    assert {f: getattr(got, f) for f in HOST_FIELDS} == {f: getattr(want, f) for f in HOST_FIELDS}
    assert got.bit_identical and want.bit_identical
