"""The port's ANN serving layer (``repro_torch.serve.ann``) against the JAX
package's (``repro.serve.ann``), on the CPU.

Both packages serve one shared index (the JAX package's ``.npz`` artifact,
loaded by the port) through engines with the same policy, and each case
drives the JAX package's server and the port's with the same script of
submits, steps and clock advances, each on its own ``VirtualClock`` (the
JAX package's, which the port does not import).  Per request the ids must
be equal except where the JAX package's own distances tie (rtol 2e-5), and
``degrade_level``, ``quality_bound``, ``error``, ``shed``, ``expired`` and
``retries`` exactly equal; per step ``(n_requests, k, bucket, level,
compile_count)``; and the outcome fields of ``latency_summary``.  The cases
are those of ``tests/test_serve_resilience.py`` and
``tests/test_serve_async.py``, a degradation ladder over a mutable engine,
the CLI, and the host-sync rule over ``src/repro_torch/serve/``.
"""

import ast
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest

from repro.core import suco as jsuco
from repro.serve import ann as jann
from repro.serve.chaos import VirtualClock

from repro_torch.core import suco as psuco
from repro_torch.data import gaussian_mixture, make_dataset, make_queries
from repro_torch.serve import ann as pann

ROOT = Path(__file__).resolve().parents[1]
CFG = jsuco.SuCoConfig(n_subspaces=8, sqrt_k=16, kmeans_iters=4, seed=0)
POLICY = dict(alpha=0.05, beta=0.02, batch_buckets=(4, 16))
OUTCOMES = ("n_shed", "n_expired", "n_failed", "n_degraded", "quality_bound_min",
            "deadline_hit_rate")


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The dataset and one index: built by the JAX package, saved, and
    loaded by the port from the artifact."""
    ds = make_dataset("gaussian_mixture", 4000, 32, m=40, k=10, seed=0)
    jidx = jsuco.build_index(jnp.asarray(ds.x), CFG)
    path = tmp_path_factory.mktemp("ann") / "index.npz"
    jidx.save(path, CFG)
    pidx, _ = psuco.load_index_artifact(path, device="cpu")
    return SimpleNamespace(ds=ds, q=ds.queries, jidx=jidx, pidx=pidx)


def sides(shared) -> tuple[SimpleNamespace, SimpleNamespace]:
    """(the JAX package's side, the port's side): each package's serving
    module and a fresh engine of it over the shared index."""
    ref = SimpleNamespace(ann=jann, engine=jsuco.SuCoEngine(
        jnp.asarray(shared.ds.x), shared.jidx, jsuco.EnginePolicy(**POLICY)))
    port = SimpleNamespace(ann=pann, engine=psuco.SuCoEngine(
        shared.ds.x, shared.pidx, psuco.EnginePolicy(**POLICY), device="cpu"))
    return ref, port


def same_ids(want_ids, want_d, got_ids, got_d, rtol=2e-5, what=""):
    """Ids equal except at the JAX package's own fp ties; distances close."""
    want_ids, got_ids = np.asarray(want_ids), np.asarray(got_ids)
    want_d, got_d = np.asarray(want_d), np.asarray(got_d)
    assert got_ids.shape == want_ids.shape, what
    np.testing.assert_allclose(got_d, want_d, rtol=rtol, err_msg=what)
    for c in np.flatnonzero(want_ids != got_ids):
        tied = np.abs(want_d - want_d[c]) <= rtol * want_d[c]
        assert tied.sum() > 1, (what, c)


def assert_same_run(ref_server, port_server):
    """Per request, per step and ``latency_summary``: the port's server
    against the JAX package's after the same script."""
    want = {r.rid: r for r in ref_server.completed}
    got = {r.rid: r for r in port_server.completed}
    assert list(got) == list(want)  # same completion order
    for rid, w in want.items():
        g = got[rid]
        for field in ("degrade_level", "quality_bound", "error", "shed", "expired",
                      "retries", "k"):
            assert getattr(g, field) == getattr(w, field), (rid, field)
        assert g.done == w.done, rid
        if w.done:
            assert g.ids.dtype == np.int32
            same_ids(w.ids, w.dists, g.ids, g.dists, what=f"rid {rid}")
    fields = ("n_requests", "k", "bucket", "level", "compile_count")
    assert [tuple(getattr(s, f) for f in fields) for s in port_server.steps] == [
        tuple(getattr(s, f) for f in fields) for s in ref_server.steps]
    ws = jann.latency_summary(ref_server.completed)
    gs = pann.latency_summary(port_server.completed)
    assert set(gs) == set(ws)
    assert {f: gs[f] for f in OUTCOMES} == {f: ws[f] for f in OUTCOMES}
    assert gs["n_requests"] == ws["n_requests"]


def run_both(shared, script):
    """Run ``script(side, clock) -> server`` on each package with a fresh
    engine and virtual clock; compare the servers; return both."""
    servers = [script(side, VirtualClock()) for side in sides(shared)]
    assert_same_run(*servers)
    return servers


# ---- validation, deadlines, admission -------------------------------------


@pytest.mark.parametrize("cls", ["AnnServer", "AsyncAnnServer"])
def test_validation_rejects_per_request(shared, cls):
    q = shared.q

    def script(side, clock):
        side.engine.warmup(batch_sizes=(1, 4), ks=(10,))
        server = getattr(side.ann, cls)(side.engine, max_batch=4, clock=clock,
                                        sleep=clock.advance)
        nan_q = np.array(q[0], dtype=np.float32)
        nan_q[3] = np.nan
        accepted = [server.submit(side.ann.AnnRequest(0, q[1], k=10)),
                    server.submit(side.ann.AnnRequest(1, nan_q, k=10)),
                    server.submit(side.ann.AnnRequest(2, q[2][:7], k=10)),
                    server.submit(side.ann.AnnRequest(3, q[3], k=0)),
                    server.submit(side.ann.AnnRequest(4, q[4], k=10)),
                    server.submit(side.ann.AnnRequest(5, q[5], k=4001))]
        assert accepted == [True, False, False, False, True, False]
        server.run_until_drained()
        return server

    _, port = run_both(shared, script)
    by = {r.rid: r for r in port.completed}
    assert "NaN" in by[1].error and "query must be" in by[2].error and "k=0" in by[3].error


def test_oldest_deadline_first(shared):
    q = shared.q
    order = []

    def script(side, clock):
        side.engine.warmup(batch_sizes=(1, 4), ks=(5, 10))
        server = side.ann.AnnServer(side.engine, max_batch=4, clock=clock, sleep=clock.advance)
        server.submit(side.ann.AnnRequest(0, q[0], k=10))
        server.submit(side.ann.AnnRequest(1, q[1], k=5, deadline_s=0.010))
        server.submit(side.ann.AnnRequest(2, q[2], k=5, deadline_s=0.500))
        order.append([[r.rid for r in server.step()], [r.rid for r in server.step()]])
        return server

    run_both(shared, script)
    assert order == [[[1, 2], [0]]] * 2


def test_expired_and_deadline_hit_rate(shared):
    q = shared.q

    def script(side, clock):
        side.engine.warmup(batch_sizes=(1, 4), ks=(10,))
        server = side.ann.AnnServer(side.engine, max_batch=4, clock=clock, sleep=clock.advance)
        server.submit(side.ann.AnnRequest(0, q[0], k=10, deadline_s=0.005))
        server.submit(side.ann.AnnRequest(1, q[1], k=10))
        server.submit(side.ann.AnnRequest(2, q[2], k=10, deadline_s=60.0))
        clock.advance(0.02)  # rid 0's deadline passes while queued
        server.run_until_drained()
        return server

    _, port = run_both(shared, script)
    by = {r.rid: r for r in port.completed}
    assert by[0].expired and "expired" in by[0].error and by[2].hit_deadline
    s = pann.latency_summary(port.completed)
    assert s["n_expired"] == 1 and s["n_failed"] == 0 and s["deadline_hit_rate"] == 0.5


def test_bounded_admission_sheds(shared):
    q = shared.q

    def script(side, clock):
        side.engine.warmup(batch_sizes=(1, 4), ks=(10,))
        server = side.ann.AnnServer(side.engine, max_batch=4, clock=clock, max_queue=2)
        assert server.submit_many([side.ann.AnnRequest(i, q[i], k=10) for i in range(5)]) == 2
        server.run_until_drained()
        with pytest.raises(ValueError, match="max_queue"):
            side.ann.AnnServer(side.engine, max_queue=0)
        return server

    _, port = run_both(shared, script)
    assert pann.latency_summary(port.completed)["n_shed"] == 3


def test_overload_controller_hysteresis_is_the_references():
    kw = dict(max_level=2, high_depth=8, low_depth=2, high_wait_s=0.1, patience=2, cooldown=2)
    hand = [(0, 0.0), (10, 0.0), (10, 0.0), (3, 0.5), (3, 0.5), (100, 1.0), (100, 1.0),
            (5, 0.01), (0, 0.0), (0, 0.0), (0, 0.0), (0, 0.0)]
    rng = np.random.default_rng(0)
    seq = hand + [(int(rng.integers(0, 12)), float(rng.random() * 0.2)) for _ in range(300)]
    want, got = jann.OverloadController(**kw), pann.OverloadController(**kw)
    levels = [got.update(*o) for o in seq]
    assert levels == [want.update(*o) for o in seq]
    assert levels[:12] == [0, 0, 1, 1, 2, 2, 2, 2, 2, 1, 1, 0]


# ---- the degradation ladder ----------------------------------------------


def test_ladder_statistics_and_bounds_are_the_references(shared):
    ref, port = sides(shared)
    want = jann.DegradationLadder(ref.engine, levels=2)
    got = pann.DegradationLadder(port.engine, levels=2)
    assert (got.m_stat, got.sigma_stat) == (want.m_stat, want.sigma_stat)
    for lv in range(4):
        for k in (1, 10, 50):
            assert got.quality_bound(lv, k) == want.quality_bound(lv, k), (lv, k)
    bounds = [got.quality_bound(lv, 10) for lv in range(3)]
    assert bounds[0] >= bounds[1] >= bounds[2] >= 0.0
    for a, b in zip(got.engines, want.engines):
        assert (a.policy.alpha, a.policy.beta) == (b.policy.alpha, b.policy.beta)
        assert a.x is port.engine.x and a.index.cell_ids is port.engine.index.cell_ids
    with pytest.raises(ValueError):
        pann.DegradationLadder(port.engine, levels=-1)


def test_forced_degrade_recover_cycle(shared):
    q = shared.q

    def script(side, clock):
        ladder = side.ann.DegradationLadder(side.engine, levels=2)
        ladder.warmup(batch_sizes=(1, 4), ks=(10,))
        server = side.ann.AnnServer(side.engine, max_batch=4, clock=clock, ladder=ladder)
        before = server.executables
        for level in (0, 1, 2, 1, 0):
            server.level = level
            server.submit_many([side.ann.AnnRequest(4 * len(server.steps) + i, q[4 * level + i],
                                                    k=10) for i in range(4)])
            batch = server.step()
            assert [r.degrade_level for r in batch] == [level] * 4
            assert all(r.quality_bound == ladder.quality_bound(level, 10) for r in batch)
        assert server.executables == before
        return server

    _, port = run_both(shared, script)
    s = pann.latency_summary(port.completed)
    assert s["n_degraded"] == 12 and s["quality_bound_min"] == port.ladder.quality_bound(2, 10)


def test_controller_driven_degrade(shared):
    q = shared.q

    def script(side, clock):
        ladder = side.ann.DegradationLadder(side.engine, levels=1)
        ladder.warmup(batch_sizes=(1, 4), ks=(10,))
        server = side.ann.AnnServer(
            side.engine, max_batch=4, clock=clock, ladder=ladder,
            controller=side.ann.OverloadController(max_level=1, high_depth=8, low_depth=0,
                                                   patience=1, cooldown=10))
        server.submit_many([side.ann.AnnRequest(i, q[i % 40], k=10) for i in range(16)])
        server.run_until_drained()
        return server

    _, port = run_both(shared, script)
    assert any(r.degrade_level == 1 for r in port.completed)


def test_ladder_over_a_mutable_engine():
    """Integer data and integer centroids, so an insert's assignment is
    exact in both packages; after ``server.insert`` / ``server.delete`` no
    level answers a deleted id and every level answers as the JAX
    package's does."""
    x = np.round(gaussian_mixture(3000, 32, 0, spread=3.0))
    cfg = jsuco.SuCoConfig(n_subspaces=8, sqrt_k=8, kmeans_iters=3, build_mode="chunked",
                           block_n=1024)
    jidx = jsuco.build_index(jnp.asarray(x), cfg)
    jidx = dataclasses.replace(jidx, centroids1=jnp.round(jidx.centroids1),
                               centroids2=jnp.round(jidx.centroids2))
    pidx = psuco.SuCoIndex.from_numpy(
        *(np.asarray(a) for a in (jidx.centroids1, jidx.centroids2, jidx.cell_ids,
                                  jidx.cell_counts)),
        spec=psuco.sub.SubspaceSpec(32, 8, jidx.spec.perm, jidx.spec.bounds), sqrt_k=8,
        device="cpu")
    new = np.round(gaussian_mixture(400, 32, 11, spread=3.0))
    q = np.round(make_queries(np.concatenate([x, new]), 24, seed=3) * 4) / 4
    dead = np.random.default_rng(4).choice(3400, 300, replace=False)
    kw = dict(alpha=0.05, beta=0.02, batch_buckets=(4, 16))
    pair = (SimpleNamespace(ann=jann, engine=jsuco.SuCoEngine(jnp.asarray(x), jidx,
                                                   jsuco.EnginePolicy(**kw), capacity=3600)),
            SimpleNamespace(ann=pann, engine=psuco.SuCoEngine(x, pidx, psuco.EnginePolicy(**kw),
                                                   capacity=3600, device="cpu")))
    servers = []
    for side in pair:
        ladder = side.ann.DegradationLadder(side.engine, levels=2)
        ladder.warmup(batch_sizes=(4,), ks=(10,))
        server = side.ann.AnnServer(side.engine, max_batch=4, clock=VirtualClock(),
                                    ladder=ladder)
        np.testing.assert_array_equal(server.insert(new), np.arange(3000, 3400))
        assert server.delete(dead) == 300
        for level in (0, 1, 2, 1, 0):
            server.level = level
            server.submit_many([side.ann.AnnRequest(4 * len(server.steps) + i, q[4 * level + i],
                                                    k=10) for i in range(4)])
            server.step()
        servers.append(server)
    assert_same_run(*servers)
    port = servers[1]
    assert {r.degrade_level for r in port.completed} == {0, 1, 2}
    assert not np.isin(np.concatenate([r.ids for r in port.completed]), dead).any()
    assert port.ladder.quality_bound(2, 10) == servers[0].ladder.quality_bound(2, 10)
    assert all(e.n_live == 3100 for e in port.ladder.engines)


# ---- retry and isolation --------------------------------------------------


class _FlakyEngine:
    """Raises on the first ``fail_n`` dispatches, then delegates."""

    def __init__(self, engine, fail_n):
        self._engine = engine
        self.fail_n = fail_n
        self.calls = 0

    def query(self, q, k):
        self.calls += 1
        if self.calls <= self.fail_n:
            raise RuntimeError(f"transient dispatch error #{self.calls}")
        return self._engine.query(q, k=k)

    def __getattr__(self, name):
        return getattr(self._engine, name)


@pytest.mark.parametrize("cls", ["AnnServer", "AsyncAnnServer"])
@pytest.mark.parametrize("fail_n", [1, 2, 10**9])
def test_retry_and_isolation(shared, cls, fail_n):
    q = shared.q
    calls = []

    def script(side, clock):
        side.engine.warmup(batch_sizes=(1, 4), ks=(10,))
        flaky = _FlakyEngine(side.engine, fail_n)
        server = getattr(side.ann, cls)(flaky, max_batch=4, clock=clock, sleep=clock.advance)
        server.submit_many([side.ann.AnnRequest(i, q[i], k=10) for i in range(3)])
        server.run_until_drained()
        calls.append(flaky.calls)
        return server

    _, port = run_both(shared, script)
    assert calls[0] == calls[1] == {1: 2, 2: 5, 10**9: 5}[fail_n]
    if fail_n == 10**9:
        assert pann.latency_summary(port.completed)["n_failed"] == 3
    else:
        assert all(r.done and r.retries == 1 for r in port.completed)


# ---- the pipelined server ------------------------------------------------

MIXED_KS = (10, 10, 5, 10, 5, 5, 10, 5, 10, 10, 5, 10)


def test_async_equals_sync(shared):
    q = shared.q
    sync = {}

    def script(side, clock):
        side.engine.warmup(batch_sizes=(1, 4, 16), ks=(5, 10))
        s = side.ann.AnnServer(side.engine, max_batch=4, clock=clock)
        s.submit_many([side.ann.AnnRequest(i, q[i], k=k) for i, k in enumerate(MIXED_KS)])
        s.run_until_drained()
        sync[side.ann] = s
        a = side.ann.AsyncAnnServer(side.engine, max_batch=4, clock=clock, depth=2)
        a.submit_many([side.ann.AnnRequest(i, q[i], k=k) for i, k in enumerate(MIXED_KS)])
        a.run_until_drained()
        assert a.inflight == 0
        return a

    _, port = run_both(shared, script)
    by_sync = {r.rid: r for r in sync[pann].completed}
    for r in port.completed:
        np.testing.assert_array_equal(r.ids, by_sync[r.rid].ids)
        np.testing.assert_array_equal(r.dists, by_sync[r.rid].dists)
    assert [(s.k, s.n_requests) for s in port.steps] == [
        (s.k, s.n_requests) for s in sync[pann].steps]
    assert_same_run(sync[jann], sync[pann])


def test_async_window_is_bounded(shared):
    q = shared.q

    def script(side, clock):
        side.engine.warmup(batch_sizes=(1,), ks=(10,))
        for depth in (1, 2, 3):
            server = side.ann.AsyncAnnServer(side.engine, max_batch=1, clock=clock, depth=depth)
            server.submit_many([side.ann.AnnRequest(i, q[i], k=10) for i in range(8)])
            seen = 0
            while server.queue:
                server.step()
                seen = max(seen, server.inflight)
                assert server.inflight <= depth
            assert seen == depth
            server.flush()
            assert server.inflight == 0 and len(server.completed) == 8
        with pytest.raises(ValueError, match="depth"):
            side.ann.AsyncAnnServer(side.engine, depth=0)
        return server

    run_both(shared, script)


def test_mixed_replay_autoscale_and_zero_new_pairs(shared):
    """A mixed-k replay feeds the traffic histogram as the JAX package's
    does; the autoscaled engine warms the observed sizes and replays with no
    new (bucket, k) pair."""
    q = shared.q
    rng_ks = np.random.default_rng(0).choice([5, 10], 40)
    record = {}

    def script(side, clock):
        side.engine.warmup(batch_sizes=(1, 2, 3, 4), ks=(5, 10))
        warm = side.engine.compile_count
        server = side.ann.AsyncAnnServer(side.engine, max_batch=4, clock=clock, depth=2)
        for i, k in enumerate(rng_ks):
            server.submit(side.ann.AnnRequest(i, q[i], k=int(k)))
            if i % 3 == 2:
                server.step()
        server.run_until_drained()
        assert side.engine.compile_count == warm
        auto = side.engine.autoscaled()
        fresh = auto.warmup(None, ks=(5, 10))
        replay = side.ann.AnnServer(auto, max_batch=4, clock=clock)
        replay.submit_many([side.ann.AnnRequest(i, q[i], k=int(k)) for i, k in enumerate(rng_ks)])
        replay.run_until_drained()
        record[side.ann] = (dict(side.engine.policy.traffic), side.engine.policy.autoscale_buckets(),
                            auto.policy.batch_buckets, fresh, auto.compile_count,
                            tuple(side.engine.stats())[:5], tuple(auto.stats())[:5])
        return server

    run_both(shared, script)
    assert record[pann] == record[jann]
    assert record[pann][3] == record[pann][4]  # the replay met no new pair


def test_autoscale_edge_histograms_are_the_references():
    for hist, n_b, fb in (({4: 0, 8: 0}, 4, (1, 2)), ({7: 13}, 8, (1,)), ({7: 13}, 1, (1,)),
                          ({1: 5, 2: 3, 5: 1, 8: 9, 16: 2}, 3, (4,)), ({3: 1, 9: 1}, 8, ())):
        want = jsuco.autoscale_buckets(hist, n_b, fallback=fb)
        assert psuco.autoscale_buckets(hist, n_b, fallback=fb) == want
        assert psuco.padding_waste(hist, want) == jsuco.padding_waste(hist, want)
    for bad in (lambda m: m.autoscale_buckets({}, 4, fallback=()),
                lambda m: m.autoscale_buckets({3: 1}, 0), lambda m: m.batch_bucket(3, ())):
        for mod in (jsuco, psuco):
            with pytest.raises(ValueError):
                bad(mod)
    p = psuco.EnginePolicy()
    p.observe([5] * 9)
    assert p.autoscale_buckets() == (5,) and p.autoscaled().batch_buckets == (5,)
    assert p.autoscaled().traffic == {5: 9} and p == psuco.EnginePolicy()  # traffic not compared
    assert psuco.EnginePolicy().autoscale_buckets() == psuco.DEFAULT_BATCH_BUCKETS
    with pytest.raises(ValueError):
        p.observe([0])
    # the histogram stays bounded: the least frequent (smallest on ties) bin goes
    want, got = jsuco.EnginePolicy(), psuco.EnginePolicy()
    sizes = np.random.default_rng(1).integers(1, 900, 3000).tolist()
    want.observe(sizes)
    got.observe(sizes)
    assert got.traffic == want.traffic and len(got.traffic) == psuco.EnginePolicy.TRAFFIC_MAX_BINS
    got.reset_traffic()
    assert not got.traffic


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_degraded_policy_is_the_references(level):
    from repro.core.tuning import TileConfig as JTiles
    from repro_torch.core.tuning import TileConfig as PTiles

    for tiles in (None, (4096, 256), (2048, 64), (8192, 1000)):
        kw = None if tiles is None else dict(block_n=tiles[0], survivor_cap=tiles[1])
        want = jsuco.EnginePolicy(alpha=0.07, beta=0.03,
                                  tiles=kw and JTiles(**kw)).degraded(level)
        got = psuco.EnginePolicy(alpha=0.07, beta=0.03, tiles=kw and PTiles(**kw)).degraded(level)
        assert (got.alpha, got.beta) == (want.alpha, want.beta)
        assert (None if got.tiles is None else got.tiles.survivor_cap) == (
            None if want.tiles is None else want.tiles.survivor_cap)
    with pytest.raises(ValueError):
        psuco.EnginePolicy().degraded(-1)


def test_latency_summary_empty_is_the_references(shared):
    for reqs in ([], [0]):
        want = jann.latency_summary([jann.AnnRequest(0, shared.q[0], k=10) for _ in reqs])
        got = pann.latency_summary([pann.AnnRequest(0, shared.q[0], k=10) for _ in reqs])
        assert got == want and got["n_requests"] == 0 and got["quality_bound_min"] == 1.0


# ---- the CLI ---------------------------------------------------------------

_LINE = re.compile(r"\[ann-serve(-async)?\] (\d+) requests in (\d+) steps: .* qps, p50 .* ms, "
                   r"p99 .* ms \(queue p50 .* / exec p50 .*\), executables (\d+)")


def _cli(module: str, *args: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-m", module, "--n", "4000", "--d", "32",
                             "--requests", "32", *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _summary(proc: subprocess.Popen) -> re.Match:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    match = _LINE.fullmatch(out.strip().splitlines()[-1])
    assert match, out
    return match


def test_cli_prints_the_references_summary():
    procs = [_cli("repro.serve.ann", "--sync"),
             _cli("repro_torch.serve.ann", "--device", "cpu", "--sync"),
             _cli("repro_torch.serve.ann", "--device", "cpu")]
    try:
        want, *got = [_summary(p) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert [g.group(1) for g in got] == [None, "-async"]
    for g in got:
        assert g.group(2, 3, 4) == want.group(2, 3, 4)


# ---- the host-sync rule ----------------------------------------------------

SYNC_ATTRS = ("item", "cpu", "numpy", "tolist")
_OK = re.compile(r"#\s*host-sync: ok — \S")


def host_syncs(source: str) -> list[tuple[int, str, bool]]:
    """``(line, what, annotated)`` for each ``.item()`` / ``.cpu()`` /
    ``.numpy()`` / ``.tolist()`` call and each ``torch.cuda.synchronize``
    in ``source``; annotated where the line carries ``# host-sync: ok —
    <reason>``."""
    lines = source.splitlines()
    found = []
    for node in ast.walk(ast.parse(source)):
        what = None
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in SYNC_ATTRS):
            what = f".{node.func.attr}()"
        elif isinstance(node, ast.Attribute) and ast.unparse(node) == "torch.cuda.synchronize":
            what = "torch.cuda.synchronize"
        if what is not None:
            line = node.end_lineno if isinstance(node, ast.Call) else node.lineno
            found.append((line, what, bool(_OK.search(lines[line - 1]))))
    return sorted(found)


def test_serve_package_host_syncs_are_annotated():
    files = sorted((ROOT / "src" / "repro_torch" / "serve").glob("*.py"))
    assert {f.name for f in files} >= {"__init__.py", "ann.py"}
    flagged = {f.name: [s for s in host_syncs(f.read_text()) if not s[2]] for f in files}
    assert all(not v for v in flagged.values()), flagged
    ann = (ROOT / "src" / "repro_torch" / "serve" / "ann.py").read_text()
    annotated = [ln for ln in ann.splitlines() if _OK.search(ln)]
    # the sync step, the retire point and the isolation path, ids and dists each
    assert len(annotated) == 6 and len(host_syncs(ann)) == 12
    reasons = {ln.split("host-sync: ok — ")[1] for ln in annotated}
    assert reasons == {"the sync serving step", "the retire point", "failure-isolation path"}


def test_host_sync_rule_flags_an_unannotated_copy():
    snippet = ("import torch\n"
               "def f(t):\n"
               "    a = t.cpu()\n"
               "    b = t.sum().item()  # host-sync: ok — a reason\n"
               "    torch.cuda.synchronize()\n"
               "    return a, b, t.tolist()  # host-sync: ok\n")
    # a reason is required after the dash
    assert host_syncs(snippet) == [(3, ".cpu()", False), (4, ".item()", True),
                                   (5, "torch.cuda.synchronize", False), (6, ".tolist()", False)]
