"""The port's live-mutation layer (``repro_torch.serve.mutation``) against the
JAX package's (``repro.serve.mutation``), on the CPU.

Both packages serve one index over integer-valued points whose centroids
are rounded to integers, so every insert's assignment, every count and the
drift statistics are exact in both arithmetics.

Tolerances: ``DriftReport``'s ``tv_distance``, ``dead_fraction`` and
``fill_fraction`` exactly, ``inertia_ratio`` within rtol 1e-5 (fp32 sums of
the inertia in another order), ``reasons`` equal; key tables (``_keys``,
``live_keys``, ``keys_of``) exactly; a re-index fed the JAX package's own
draws with centroids within 1e-5 and at least 99.9% of cell ids equal (a
point on a Voronoi boundary can flip between the two arithmetics, as in
``tests/test_torch_lifecycle.py``); the mutate-while-serving replay of
``tests/test_mutation_serving.py`` with outcome sets equal, no new (bucket,
k) pair, and before the re-index ids equal except at the JAX package's own
fp ties (rtol 2e-5).
"""

import dataclasses
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.core import subspace as jsub
from repro.core import suco as jsuco
from repro.serve import ann as jann
from repro.serve import chaos as jchaos
from repro.serve import durability as jdur
from repro.serve import mutation as jmut

from repro_torch.core import suco as psuco
from repro_torch.data import gaussian_mixture, make_dataset
from repro_torch.serve import ann as pann
from repro_torch.serve import chaos as pchaos
from repro_torch.serve import durability as pdur
from repro_torch.serve import mutation as pmut

T = torch.from_numpy
K = 10
D = 32
POLICY = dict(alpha=0.05, beta=0.02, batch_buckets=(4, 16))
# the manager's build config; a re-index forces build_mode="minibatch"
MCFG = dict(n_subspaces=8, sqrt_k=8, kmeans_iters=3, seed=0, block_n=512)


def _port_index(jidx, device="cpu"):
    return psuco.SuCoIndex.from_numpy(
        *(np.asarray(a) for a in (jidx.centroids1, jidx.centroids2, jidx.cell_ids,
                                  jidx.cell_counts)),
        spec=psuco.sub.SubspaceSpec(jidx.spec.d, jidx.spec.n_subspaces, jidx.spec.perm,
                                    jidx.spec.bounds),
        sqrt_k=jidx.sqrt_k,
        tombstone=None if jidx.tombstone is None else np.asarray(jidx.tombstone),
        device=device,
    )


@pytest.fixture(scope="module")
def shared():
    """Integer points and a JAX index over them with integer centroids, and
    the same index in the port."""
    x = np.round(gaussian_mixture(3000, D, 0, spread=3.0))
    cfg = jsuco.SuCoConfig(n_subspaces=8, sqrt_k=8, kmeans_iters=3, build_mode="chunked",
                           block_n=1024)
    jidx = jsuco.build_index(jnp.asarray(x), cfg)
    jidx = dataclasses.replace(jidx, centroids1=jnp.round(jidx.centroids1),
                               centroids2=jnp.round(jidx.centroids2))
    new = np.round(gaussian_mixture(400, D, 11, spread=3.0))
    far = np.round(gaussian_mixture(100, D, 12, spread=3.0) + 6.0)  # higher inertia
    return SimpleNamespace(x=x, jidx=jidx, pidx=_port_index(jidx), new=new, far=far)


def sides(shared, **engine_kw):
    """(the JAX package's side, the port's side): each package's modules and
    a fresh mutable engine of it over the shared index."""
    ref = SimpleNamespace(
        name="ref", ann=jann, mut=jmut, chaos=jchaos, dur=jdur,
        cfg=jsuco.SuCoConfig(**MCFG),
        engine=jsuco.SuCoEngine(jnp.asarray(shared.x), shared.jidx,
                                jsuco.EnginePolicy(**POLICY), **engine_kw))
    port = SimpleNamespace(
        name="port", ann=pann, mut=pmut, chaos=pchaos, dur=pdur,
        cfg=psuco.SuCoConfig(**MCFG),
        engine=psuco.SuCoEngine(shared.x, shared.pidx, psuco.EnginePolicy(**POLICY),
                                device="cpu", **engine_kw))
    return ref, port


def stack(side, *, monitor=None, levels=1, capacity_factor=1.5):
    ladder = side.ann.DegradationLadder(side.engine, levels=levels)
    clock = side.chaos.VirtualClock()
    server = side.ann.AnnServer(side.engine, max_batch=4, clock=clock, ladder=ladder,
                                sleep=clock.advance)
    ladder.warmup(batch_sizes=(1, 4), ks=(K,))
    mgr = side.mut.MutationManager(
        server, side.cfg, capacity_factor=capacity_factor,
        monitor=None if monitor is None else side.mut.DriftMonitor(**monitor))
    return server, mgr


def reference_draws(x: np.ndarray, cfg) -> tuple[np.ndarray, torch.Tensor]:
    """The JAX package's minibatch draws for a build of ``x`` under ``cfg``:
    the kmeans++ seeds and every step's sample (``tests/test_torch_lifecycle.py``)."""
    n = x.shape[0]
    spec = jsub.contiguous_spec(x.shape[1], cfg.n_subspaces)
    h1, h2 = jsub.split_halves_padded(spec, jsub.permute(spec, jnp.asarray(x)))
    key = jax.random.key(cfg.seed)
    seeds = np.array(jkm._init_batched(key, jnp.concatenate([h1, h2]), cfg.sqrt_k, "auto",
                                       "minibatch"))
    bn = min(cfg.block_n, n)
    sample = np.stack([np.array(jax.random.randint(jax.random.fold_in(key, t), (bn,), 0, n))
                       for t in range(cfg.kmeans_iters)])
    return seeds, T(sample)


def build_with_reference_draws(x, config, **kw):
    """The port's ``build_index`` fed the JAX package's draws."""
    seeds, sample = reference_draws(x.cpu().numpy(), config)
    return psuco.build_index(x, config, init_centroids=T(seeds), sample_idx=sample, **kw)


def same_ids(want_ids, want_d, got_ids, got_d, rtol=2e-5, what=""):
    """Ids equal except at the JAX package's own fp ties; distances close."""
    want_ids, got_ids = np.asarray(want_ids), np.asarray(got_ids)
    want_d, got_d = np.asarray(want_d), np.asarray(got_d)
    assert got_ids.shape == want_ids.shape, what
    np.testing.assert_allclose(got_d, want_d, rtol=rtol, err_msg=what)
    for c in np.flatnonzero(want_ids != got_ids):
        tied = np.abs(want_d - want_d[c]) <= rtol * want_d[c]
        assert tied.sum() > 1, (what, c)


def assert_same_report(got, want, what):
    """tv, dead and fill fractions exactly, the inertia ratio within rtol
    1e-5, the reasons equal."""
    assert got.tv_distance == want.tv_distance, what
    assert got.dead_fraction == want.dead_fraction, what
    assert got.fill_fraction == want.fill_fraction, what
    np.testing.assert_allclose(got.inertia_ratio, want.inertia_ratio, rtol=1e-5, err_msg=what)
    assert got.reasons == want.reasons, what
    assert got.triggered == want.triggered, what


def assert_same_keys(pm, jm, what, probe=(0, 1, 7, 100, 2999)):
    """``_keys``, ``_next_key``, ``live_keys`` and ``keys_of`` exactly."""
    np.testing.assert_array_equal(pm._keys, jm._keys, err_msg=what)
    assert pm._next_key == jm._next_key, what
    np.testing.assert_array_equal(pm.live_keys(), jm.live_keys(), err_msg=what)
    probe = np.asarray([p for p in probe if p < len(jm._keys)])
    np.testing.assert_array_equal(pm.keys_of(probe), jm.keys_of(probe), err_msg=what)


# ---- drift reports and key tables -----------------------------------------


def test_drift_reports_and_key_tables_match_reference(shared, monkeypatch):
    """The same insert / delete / re-index sequence on both packages: each
    ``DriftReport`` and the key tables after each step; the re-index fed the
    JAX package's draws gives its centroids and cell ids."""
    monkeypatch.setattr(pmut, "build_index", build_with_reference_draws)
    monitor = dict(tv_threshold=0.05, max_dead_fraction=0.15, max_fill_fraction=0.9,
                   inertia_ratio_threshold=1.5)
    pair = [stack(side, monitor=monitor) for side in sides(shared, capacity=3600)]
    steps = [
        ("start", lambda m: None),
        ("insert", lambda m: m.insert(shared.new)),
        ("delete", lambda m: m.delete(np.arange(0, 700))),
        ("insert far", lambda m: m.insert(shared.far, keys=np.arange(9000, 9100))),
        ("delete again", lambda m: m.delete(np.asarray([3005, 3010, 9001, 5]))),
    ]
    reports = []
    for name, step in steps:
        outs = [step(m) for _, m in pair]
        (js, jm), (ps, pm) = pair
        if name.startswith("insert"):
            np.testing.assert_array_equal(outs[1], outs[0])
        assert_same_keys(pm, jm, name)
        want, got = jm.check(), pm.check()
        assert_same_report(got, want, name)
        reports.append(got)
    assert reports[0].reasons == ()
    assert {r.split()[0] for r in reports[-1].reasons} >= {"occupancy", "dead", "insert"}

    (js, jm), (ps, pm) = pair
    want_engine, got_engine = jm.reindex(), pm.reindex()
    assert pm.reindexes == jm.reindexes == 1
    assert got_engine is ps.engine
    assert_same_keys(pm, jm, "reindex")
    assert_same_report(pm.check(), jm.check(), "after the re-index")
    assert got_engine.capacity == want_engine._capacity
    for a, b in ((want_engine.index.centroids1, got_engine.index.centroids1),
                 (want_engine.index.centroids2, got_engine.index.centroids2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    n_live = got_engine.n_live
    same = got_engine.index.cell_ids[:, :n_live].numpy() == np.asarray(
        want_engine.index.cell_ids)[:, :n_live]
    assert same.mean() >= 0.999
    np.testing.assert_array_equal(got_engine.x.numpy(), np.asarray(want_engine.x))
    # every level of the successor ladder serves the warmed surface
    assert ps.executables == js.executables
    assert [sorted(e._buckets_seen) for e in ps.ladder.engines] == [
        sorted(e._buckets_seen) for e in js.ladder.engines]


def test_drift_monitor_validation_is_the_references():
    for kw in (dict(tv_threshold=0.0), dict(max_dead_fraction=1.5), dict(max_fill_fraction=0),
               dict(inertia_ratio_threshold=1.0)):
        for mod in (jmut, pmut):
            with pytest.raises(ValueError):
                mod.DriftMonitor(**kw)
    with pytest.raises(ValueError, match="no baseline"):
        pmut.DriftMonitor().observe(None)


# ---- the single-flight guard ----------------------------------------------


def _guard_script(side, mgr, rows):
    """One call after another; the name of what each raised (or "ok")."""
    out = []

    def call(fn):
        try:
            fn()
            out.append("ok")
        except Exception as e:  # noqa: BLE001 — the outcome is what is compared
            out.append(type(e).__name__)

    call(lambda: mgr.finish_reindex())
    call(lambda: mgr.reindex_async())
    call(lambda: mgr.insert(rows))
    call(lambda: mgr.delete(np.asarray([3, 4])))
    call(lambda: mgr.reindex())
    call(lambda: mgr.reindex_async())
    call(lambda: mgr.finish_reindex(timeout=300))
    call(lambda: mgr.finish_reindex())
    call(lambda: mgr.insert(rows))
    call(lambda: mgr.delete(np.asarray([3, 4])))
    call(lambda: mgr.insert(rows[:1], keys=[0]))  # a key in use
    return out


def test_reindex_in_progress_raised_at_the_same_calls(shared):
    outs = []
    for side in sides(shared, capacity=3600):
        _, mgr = stack(side)
        outs.append(_guard_script(side, mgr, shared.new[:2]))
        assert mgr.reindexes == 1 and mgr._pending is None and not mgr._reindexing
    assert outs[1] == outs[0]
    assert outs[1] == ["ValueError", "ok", "ReindexInProgressError", "ReindexInProgressError",
                       "ReindexInProgressError", "ReindexInProgressError", "ok", "ValueError",
                       "ok", "ok", "ValueError"]


def test_single_flight_claim_between_threads(shared):
    """A re-index in flight on another thread (claimed, no job pending) is
    refused, as the JAX package refuses it."""
    _, port = sides(shared, capacity=3600)
    _, mgr = stack(port)
    mgr._claim()
    try:
        with pytest.raises(pmut.ReindexInProgressError, match="single-flight"):
            mgr.reindex()
        with pytest.raises(pmut.ReindexInProgressError, match="single-flight"):
            mgr.reindex_async()
    finally:
        mgr._release()
    mgr.reindex()
    assert mgr.reindexes == 1


# ---- a prepare that fails -------------------------------------------------


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_failed_prepare_leaves_the_incumbent_serving(shared, tmp_path, mode):
    """A ``CrashPoint`` at ``reindex.mid-prepare``: the incumbent answers as
    before, nothing is logged, the guard is released, and the JAX package
    raises at the same point."""
    q = shared.new[:4] + 0.25
    for side in sides(shared, capacity=3600):
        server, mgr = stack(side)
        injector = side.chaos.CrashInjector().arm("reindex.mid-prepare")
        dur = side.dur.Durability(tmp_path / side.name / mode, crash=injector,
                                  start_worker=False).attach(server, mgr)
        before = side.dur.state_fingerprint(server, mgr)
        answers = [server.engine.query(q, k=K) for _ in range(2)]
        seq = dur.wal.appended_seq
        with pytest.raises(side.chaos.CrashPoint, match="reindex.mid-prepare"):
            if mode == "async":
                mgr.reindex_async()
                mgr.finish_reindex(timeout=300)
            else:
                mgr.reindex()
        assert injector.fired and mgr.reindexes == 0 and mgr._pending is None
        assert not side.dur.fingerprint_diff(before, side.dur.state_fingerprint(server, mgr))
        assert dur.wal.appended_seq == seq
        again = server.engine.query(q, k=K)
        np.testing.assert_array_equal(np.asarray(again.ids), np.asarray(answers[0].ids))
        np.testing.assert_array_equal(np.asarray(again.dists), np.asarray(answers[0].dists))
        mgr.reindex()  # the next re-index proceeds
        assert mgr.reindexes == 1
        dur.close()


# ---- mutate while serving -------------------------------------------------


@pytest.fixture(scope="module")
def serving():
    """``tests/test_mutation_serving.py``'s data set and one JAX index over
    it, shared with the port."""
    n, d = 2000, 16
    ds = make_dataset("gaussian_mixture", n, d, m=20, k=K, seed=0)
    cfg = jsuco.SuCoConfig(n_subspaces=4, sqrt_k=8, kmeans_iters=3, seed=0)
    jidx = jsuco.build_index(jnp.asarray(ds.x), cfg)
    return SimpleNamespace(ds=ds, n=n, d=d, jidx=jidx, pidx=_port_index(jidx),
                           cfg=dict(n_subspaces=4, sqrt_k=8, kmeans_iters=3, seed=0))


def _replay_side(serving, side, mode):
    """The reference's mutate-while-serving script on one package: a seeded
    flood through ``AsyncAnnServer`` with an insert, a delete and a re-index
    (synchronous, or ``reindex_async`` ... ``finish_reindex`` with an insert
    refused between) scripted between dispatches."""
    ds, n, d = serving.ds, serving.n, serving.d
    pol = dict(alpha=0.1, beta=0.05, mode="dense", batch_buckets=(4, 16))
    if side == "ref":
        mods = SimpleNamespace(ann=jann, mut=jmut, chaos=jchaos)
        engine = jsuco.SuCoEngine(jnp.asarray(ds.x), serving.jidx, jsuco.EnginePolicy(**pol),
                                  capacity=n + 300)
        cfg = jsuco.SuCoConfig(**serving.cfg)
    else:
        mods = SimpleNamespace(ann=pann, mut=pmut, chaos=pchaos)
        engine = psuco.SuCoEngine(ds.x, serving.pidx, psuco.EnginePolicy(**pol),
                                  capacity=n + 300, device="cpu")
        cfg = psuco.SuCoConfig(**serving.cfg)
    clock = mods.chaos.VirtualClock()
    ladder = mods.ann.DegradationLadder(engine, levels=1)
    server = mods.ann.AsyncAnnServer(engine, max_batch=8, clock=clock, sleep=clock.advance,
                                     ladder=ladder)
    ladder.warmup(batch_sizes=range(1, 9), ks=(K,))
    mgr = mods.mut.MutationManager(server, cfg, capacity_factor=1.2)
    exe_warm = server.executables
    rng = np.random.default_rng(11)
    new_rows = (ds.x[:80] + 0.1 * rng.standard_normal((80, d))).astype(np.float32)
    snap: dict = {}

    def ev_insert(_):
        snap["inserted_keys"] = mgr.insert(new_rows)

    def ev_delete(_):
        snap["t_delete"] = clock()
        snap["n_deleted"] = mgr.delete(np.arange(100, 250))

    def ev_reindex(_):
        snap["exe_pre"] = server.executables
        mgr.reindex()
        snap["t_swap"] = clock()
        snap["exe_post"] = server.executables

    def ev_start(_):
        snap["exe_pre"] = server.executables
        mgr.reindex_async()

    def ev_refused(_):
        with pytest.raises(mods.mut.ReindexInProgressError, match="pending"):
            mgr.insert(ds.x[:2])
        snap["refused"] = True

    def ev_finish(_):
        mgr.finish_reindex(timeout=300)
        snap["t_swap"] = clock()
        snap["exe_post"] = server.executables

    trace = mods.chaos.flood_trace(60, d, interarrival_s=0.001, deadline_s=None, ks=(K,),
                                   seed=3, queries=ds.x)
    trace += [(0.0155, ev_insert), (0.0305, ev_delete)]
    if mode == "sync":
        trace += [(0.0455, ev_reindex)]
    else:
        trace += [(0.0455, ev_start), (0.0505, ev_refused), (0.0555, ev_finish)]
    trace.sort(key=lambda tr: tr[0])
    report = mods.chaos.replay(server, trace, clock)
    reqs = {r.rid: r for _, r in trace if not callable(r)}
    return SimpleNamespace(report=report, reqs=reqs, snap=snap, mgr=mgr, exe_warm=exe_warm,
                           server=server)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_mutate_while_serving_replay_matches_reference(serving, mode):
    ref, port = (_replay_side(serving, side, mode) for side in ("ref", "port"))
    assert port.report.outcome_sets == ref.report.outcome_sets
    assert port.report.completed == frozenset(range(60))
    assert port.report.retraces == ref.report.retraces == 0
    assert port.report.max_level == ref.report.max_level
    assert port.snap["exe_pre"] == port.exe_warm and port.server.executables == port.snap["exe_post"]
    assert port.snap["n_deleted"] == ref.snap["n_deleted"] == 150
    np.testing.assert_array_equal(port.snap["inserted_keys"], ref.snap["inserted_keys"])
    assert port.mgr.reindexes == ref.mgr.reindexes == 1
    if mode == "async":
        assert port.snap["refused"] and ref.snap["refused"]
    np.testing.assert_array_equal(port.mgr._keys, ref.mgr._keys)
    dead = set(range(100, 250))
    t_del, t_swap = port.snap["t_delete"], port.snap["t_swap"]
    assert (t_del, t_swap) == (ref.snap["t_delete"], ref.snap["t_swap"])
    for rid, r in port.reqs.items():
        w = ref.reqs[rid]
        assert (r.t_start, r.degrade_level, r.done) == (w.t_start, w.degrade_level, w.done)
        if r.t_start < t_swap:  # the same index: the JAX package's answers
            same_ids(w.ids, w.dists, r.ids, r.dists, what=f"rid {rid}")
            keys = r.ids
        else:
            keys = port.mgr.keys_of(r.ids)
        if r.t_start >= t_del:
            assert not dead & set(map(int, keys)), f"rid {rid} answered a deleted key"
    assert any(r.t_start >= t_swap for r in port.reqs.values())
    assert any(t_del <= r.t_start < t_swap for r in port.reqs.values())


def test_warm_like_and_reindex_on_a_thread_of_its_own(shared):
    """Without a durability worker the prepare runs on a thread of its own,
    with inference mode set there; ``warm_like`` warms exactly the served
    pairs."""
    _, port = sides(shared, capacity=3600)
    server, mgr = stack(port)
    seen = {}
    real = pmut.build_index

    def spy(x, config, **kw):
        seen["thread"] = threading.current_thread().name
        seen["inference"] = torch.is_inference_mode_enabled()
        return real(x, config, **kw)

    pmut.build_index = spy
    try:
        job = mgr.reindex_async()
        mgr.finish_reindex(timeout=300)
    finally:
        pmut.build_index = real
    assert job.done and seen == {"thread": "suco-reindex-prepare", "inference": True}
    fresh = psuco.SuCoEngine(server.engine.x, server.engine.index, psuco.EnginePolicy(**POLICY),
                             device="cpu")
    assert pmut.warm_like(fresh, server.engine) == len(server.engine._buckets_seen)
    assert fresh._buckets_seen == server.engine._buckets_seen
    assert pmut.warm_like(fresh, server.engine) == 0
