"""The port's fault-injection harness (``repro_torch.serve.chaos``) against the
JAX package's (``repro.serve.chaos``), on the CPU.

Both packages serve one index (the JAX package's artifact, loaded by the
port) through the scenarios of ``tests/test_chaos.py``: the same seeded
traces (``flood_trace``) and fault schedules (``ChaosEngine``,
``wrap_ladder``) through ``replay`` give the same ``ReplayReport``: outcome
sets, ``max_level``, ``retraces`` and the outcome fields of the summary
exactly, and per request ids equal except where the JAX package's own
distances tie (rtol 2e-5).  ``drill_steps`` gives the same arrays bit for
bit, and the standard drill script reaches every ``CRASH_POINTS`` name.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import suco as jsuco
from repro.serve import ann as jann
from repro.serve import chaos as jchaos

from repro_torch.core import suco as psuco
from repro_torch.data import make_dataset
from repro_torch.serve import ann as pann
from repro_torch.serve import chaos as pchaos
from repro_torch.serve import durability as pdur
from repro_torch.serve import mutation as pmut

CFG = jsuco.SuCoConfig(n_subspaces=8, sqrt_k=16, kmeans_iters=4, seed=0)
POLICY = dict(alpha=0.05, beta=0.02, batch_buckets=(4, 16))
OUTCOMES = ("n_shed", "n_expired", "n_failed", "n_degraded", "quality_bound_min",
            "deadline_hit_rate", "n_requests")


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """``tests/test_chaos.py``'s data set and index, the index built by the
    JAX package and loaded by the port from its artifact; one warmed engine
    of each package."""
    ds = make_dataset("gaussian_mixture", 4000, 32, m=40, k=10, seed=0)
    jidx = jsuco.build_index(jnp.asarray(ds.x), CFG)
    path = tmp_path_factory.mktemp("chaos") / "index.npz"
    jidx.save(path, CFG)
    pidx, _ = psuco.load_index_artifact(path, device="cpu")
    ref = jsuco.SuCoEngine(jnp.asarray(ds.x), jidx, jsuco.EnginePolicy(**POLICY))
    port = psuco.SuCoEngine(ds.x, pidx, psuco.EnginePolicy(**POLICY), device="cpu")
    for e in (ref, port):
        e.warmup(batch_sizes=(1, 4, 16), ks=(10,))
    return SimpleNamespace(
        ds=ds,
        sides=(SimpleNamespace(ann=jann, chaos=jchaos, engine=ref),
               SimpleNamespace(ann=pann, chaos=pchaos, engine=port)))


def _chaos_replay(side, server_cls, *, chaos, trace_seed=3, n_requests=48,
                  interarrival_s=0.001, deadline_s=0.05, p_malformed=0.05, queries=None,
                  controlled=True):
    """``tests/test_chaos.py``'s replay on one package: a 2-level ladder
    wrapped in one fault schedule, a bounded queue and the overload
    controller (or, uncontrolled, a bare proxy of the engine)."""
    clock = side.chaos.VirtualClock()
    cfg = side.chaos.ChaosConfig(**chaos)
    if controlled:
        ladder = side.ann.DegradationLadder(side.engine, levels=2)
        ladder.warmup(batch_sizes=(1, 4), ks=(10,))
        side.chaos.wrap_ladder(ladder, cfg, clock)
        server = getattr(side.ann, server_cls)(
            ladder.engines[0], max_batch=4, clock=clock, sleep=clock.advance, max_queue=16,
            ladder=ladder, controller=side.ann.OverloadController(high_depth=8, low_depth=2))
    else:
        server = getattr(side.ann, server_cls)(side.chaos.ChaosEngine(side.engine, cfg, clock),
                                               max_batch=4, clock=clock, sleep=clock.advance)
    trace = side.chaos.flood_trace(n_requests, 32, interarrival_s=interarrival_s,
                                   deadline_s=deadline_s, p_malformed=p_malformed,
                                   seed=trace_seed, queries=queries)
    report = side.chaos.replay(server, trace, clock)
    return report, {r.rid: r for _, r in trace}


def assert_same_replay(ref, port):
    (want, want_reqs), (got, got_reqs) = ref, port
    assert got.outcome_sets == want.outcome_sets
    assert (got.max_level, got.retraces) == (want.max_level, want.retraces)
    assert {f: got.summary[f] for f in OUTCOMES} == {f: want.summary[f] for f in OUTCOMES}
    assert set(got.summary) == set(want.summary)
    for rid, w in want_reqs.items():
        g = got_reqs[rid]
        for field in ("error", "shed", "expired", "degrade_level", "quality_bound", "retries",
                      "t_start", "t_done"):
            assert getattr(g, field) == getattr(w, field), (rid, field)
        if w.done:
            want_d, got_d = np.asarray(w.dists), np.asarray(g.dists)
            np.testing.assert_allclose(got_d, want_d, rtol=2e-5)
            for c in np.flatnonzero(np.asarray(w.ids) != np.asarray(g.ids)):
                assert (np.abs(want_d - want_d[c]) <= 2e-5 * want_d[c]).sum() > 1, (rid, c)


CASES = {
    "mixed": dict(chaos=dict(seed=7, service_s=0.004, p_engine_error=0.1, p_latency_spike=0.15,
                             latency_spike_s=0.05)),
    "spikes": dict(chaos=dict(seed=1, service_s=0.004, p_latency_spike=0.5,
                              latency_spike_s=0.2), deadline_s=0.03, p_malformed=0.0),
    "flood": dict(chaos=dict(seed=4, service_s=0.02), n_requests=64, interarrival_s=0.0002,
                  deadline_s=None, p_malformed=0.0),
    "uncontrolled": dict(chaos=dict(seed=5, service_s=0.02), n_requests=64,
                         interarrival_s=0.0002, deadline_s=0.1, p_malformed=0.0,
                         trace_seed=6, controlled=False),
}


@pytest.mark.parametrize("server_cls", ["AnnServer", "AsyncAnnServer"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_report_is_the_references(shared, case, server_cls):
    ref, port = (_chaos_replay(side, server_cls, **CASES[case]) for side in shared.sides)
    assert_same_replay(ref, port)
    report = port[0]
    if case == "flood":
        assert report.shed and report.degraded and report.retraces == 0
    if case == "spikes":
        assert report.expired
    if case == "mixed":
        assert report.failed


def test_malformed_queries_from_rows(shared):
    ref, port = (_chaos_replay(side, "AnnServer", chaos=dict(seed=2, service_s=0.001),
                               p_malformed=0.3, deadline_s=None,
                               queries=np.asarray(shared.ds.queries))
                 for side in shared.sides)
    assert_same_replay(ref, port)
    assert port[0].failed and port[0].completed


def test_fault_schedule_is_the_references(shared):
    """The proxy's draws, spikes and errors dispatch by dispatch, and its
    delegation of everything else."""
    def schedule(side, seed):
        clock = side.chaos.VirtualClock()
        proxy = side.chaos.ChaosEngine(
            side.engine, side.chaos.ChaosConfig(seed=seed, p_engine_error=0.3,
                                                p_latency_spike=0.3), clock)
        out = []
        for _ in range(32):
            try:
                proxy.query(np.zeros((1, 32), np.float32), k=10)
                out.append(("ok", proxy.n_spikes, clock()))
            except side.chaos.ChaosError:
                out.append(("err", proxy.n_spikes, clock()))
        assert proxy.compile_count == side.engine.compile_count
        return out

    ref, port = shared.sides
    assert schedule(port, 0) == schedule(ref, 0)
    assert schedule(port, 0) != schedule(port, 1)


@pytest.mark.parametrize("kw", [dict(), dict(p_malformed=0.25), dict(ks=(5, 10, 20)),
                                dict(queries="rows", p_malformed=0.1, deadline_s=None)])
def test_flood_trace_is_the_references(shared, kw):
    if kw.get("queries") == "rows":
        kw = dict(kw, queries=shared.ds.x[:50])
    want = jchaos.flood_trace(24, 32, seed=9, **kw)
    got = pchaos.flood_trace(24, 32, seed=9, **kw)
    assert len(got) == len(want)
    for (ta, a), (tb, b) in zip(got, want):
        assert (ta, a.rid, a.k, a.deadline_s) == (tb, b.rid, b.k, b.deadline_s)
        assert a.query.dtype == b.query.dtype
        np.testing.assert_array_equal(a.query, b.query)


def test_clock_and_config_validation_are_the_references():
    for mod in (jchaos, pchaos):
        c = mod.VirtualClock()
        assert c() == 0.0 and c.advance(1.5) == 1.5
        with pytest.raises(ValueError, match="backwards"):
            c.advance(-1.0)
        with pytest.raises(ValueError, match="p_engine_error"):
            mod.ChaosConfig(p_engine_error=1.5)
        with pytest.raises(ValueError, match="unknown crash point"):
            mod.CrashInjector().arm("nowhere")
    assert pchaos.CRASH_POINTS == jchaos.CRASH_POINTS and len(pchaos.CRASH_POINTS) == 10


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_drill_steps_are_the_references(seed):
    want, got = jchaos.drill_steps(16, seed=seed), pchaos.drill_steps(16, seed=seed)
    assert [(s.kind, s.records) for s in got] == [(s.kind, s.records) for s in want]
    for a, b in zip(got, want):
        if b.payload is None:
            assert a.payload is None
        else:
            assert a.payload.dtype == b.payload.dtype
            np.testing.assert_array_equal(a.payload, b.payload)


@pytest.mark.parametrize("fsync", ["group", "always"])
def test_drill_script_reaches_every_crash_point(tmp_path, fsync):
    """Un-armed, the standard script crosses every boundary except the torn
    append (which exists only when armed); armed, the torn append fires."""
    ds = make_dataset("gaussian_mixture", 500, 16, m=10, k=5, seed=0)
    cfg = psuco.SuCoConfig(n_subspaces=4, sqrt_k=8, kmeans_iters=2, seed=0)

    def build(root, injector):
        x = torch.from_numpy(ds.x)
        engine = psuco.SuCoEngine(x, psuco.build_index(x, cfg),
                                  psuco.EnginePolicy(alpha=0.1, beta=0.05), capacity=700,
                                  device="cpu")
        ladder = pann.DegradationLadder(engine, levels=1, stats_seed=0)
        server = pann.AnnServer(engine, ladder=ladder)
        ladder.warmup([1], [5])
        manager = pmut.MutationManager(server, cfg, stats_seed=0)
        dur = pdur.Durability(root, pdur.DurabilityConfig(fsync=fsync), crash=injector,
                              start_worker=False).attach(server, manager)
        return server, manager, dur

    injector = pchaos.CrashInjector()
    server, manager, dur = build(tmp_path / "ledger", injector)
    for step in pchaos.drill_steps(16, seed=3):
        pchaos._apply_drill_step(server, manager, dur, step)
    dur.close()
    assert set(pchaos.CRASH_POINTS) - set(injector.reached) == {"wal.append.torn"}
    rep = pchaos.recovery_drill(tmp_path / "torn", build, pchaos.drill_steps(16, seed=3),
                                "wal.append.torn", queries=ds.x[:4], k=5)
    assert rep.fired and rep.dropped_bytes > 0 and rep.bit_identical and rep.lost_acked == 0
