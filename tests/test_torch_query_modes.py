"""SuCo's query modes in the port (``suco_query`` with ``mode="dense"``,
``"streaming"``, ``"fused"``, ``"auto"``) against each other and against the
JAX package, on the CPU, over one index the JAX package built and saved.

Tolerances: the port's modes equal each other **exactly** (ids, scores and
distances; on one device every mode takes its distances from the same
rerank op).  Against the JAX package's same mode: scores of matching ids
exactly, distances at each rank within ``rtol=2e-5`` (fp32 sums in another
order), and ids equal except where the reference's distances tie within
that tolerance.  These mirror ``tests/test_streaming.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import subspace as jsub
from repro.core import suco as jsuco

from repro_torch.core import suco as psuco
from repro_torch.core.tuning import TileConfig
from repro_torch.data import gaussian_mixture, make_queries

N, D, NS, SQRT_K = 4000, 32, 4, 16
ALPHA, BETA, K = 0.05, 0.02, 10
T = torch.from_numpy


def assert_same_answers(want, got, rtol=2e-5):
    """``want``: the JAX package's QueryResult, ``got``: the port's."""
    wi, wd, ws = (np.asarray(a) for a in want)
    gi, gd, gs = (a.numpy() for a in got)
    assert gi.shape == wi.shape and gi.dtype == np.int32 and gs.dtype == np.int32
    np.testing.assert_allclose(gd, wd, rtol=rtol)
    for r in range(wi.shape[0]):
        for c in np.flatnonzero(wi[r] != gi[r]):
            tied = np.abs(wd[r] - wd[r, c]) <= rtol * wd[r, c]
            assert tied.sum() > 1, (r, c)
        w_scores = dict(zip(wi[r].tolist(), ws[r].tolist()))
        for i, s in zip(gi[r].tolist(), gs[r].tolist()):
            if i in w_scores:
                assert s == w_scores[i], (r, i)


def assert_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    x = gaussian_mixture(N, D, 0)
    q = make_queries(x, 6, seed=1)
    cfg = jsuco.SuCoConfig(n_subspaces=NS, sqrt_k=SQRT_K, kmeans_iters=4, build_mode="chunked",
                           block_n=2048)
    jidx = jsuco.build_index(jnp.asarray(x), cfg)
    dead = np.random.default_rng(5).choice(N, N // 10, replace=False)
    out = dict(x=x, q=q, dead=dead, j={"plain": jidx, "tomb": jidx.delete(dead)}, p={})
    for name, idx in out["j"].items():
        path = tmp_path_factory.mktemp("art") / f"{name}.npz"
        idx.save(path, cfg)
        out["p"][name] = psuco.load_index_artifact(path, device="cpu")[0]
    return out


def _port(shared, name, mode, **kw):
    kw = dict(dict(k=K, alpha=ALPHA, beta=BETA), **kw)
    return psuco.suco_query(T(shared["x"]), shared["p"][name], T(shared["q"]), mode=mode, **kw)


@pytest.mark.parametrize("name,metric", [("plain", "l2"), ("tomb", "l2"), ("plain", "l1")])
def test_dense_and_streaming_match_the_reference_and_each_other(shared, name, metric):
    x, q = jnp.asarray(shared["x"]), jnp.asarray(shared["q"])
    kw = dict(k=K, alpha=ALPHA, beta=BETA, metric=metric)
    dense = _port(shared, name, "dense", metric=metric)
    assert_same_answers(jsuco.suco_query(x, shared["j"][name], q, mode="dense", **kw), dense)
    stream = _port(shared, name, "streaming", metric=metric, block_n=700)
    want = jsuco.suco_query_streaming(x, shared["j"][name], q, block_n=700, **kw)
    assert_same_answers(want, stream)
    assert_equal(stream, dense)
    fused = _port(shared, name, "fused", metric=metric, tiles=TileConfig(1024, survivor_cap=128))
    assert_equal(fused, dense)
    if name == "tomb":
        assert not np.isin(dense.ids.numpy(), shared["dead"]).any()


@pytest.mark.parametrize("block_n", [N, 333, 1000, 1_000_000])
@pytest.mark.parametrize("name", ["plain", "tomb"])
def test_streaming_equals_dense_for_any_chunking(shared, block_n, name):
    """One chunk, a ragged last chunk, chunks that divide n, and a chunk
    larger than n all merge to the dense pool."""
    dense = _port(shared, name, "dense")
    assert_equal(_port(shared, name, "streaming", block_n=block_n), dense)


def test_streaming_pool_larger_than_n(shared):
    """beta > 1: the pool clamps to n, and every mode still agrees."""
    dense = _port(shared, "plain", "dense", beta=1.5)
    assert_equal(_port(shared, "plain", "streaming", beta=1.5, block_n=777), dense)
    want = jsuco.suco_query(jnp.asarray(shared["x"]), shared["j"]["plain"],
                            jnp.asarray(shared["q"]), k=K, alpha=ALPHA, beta=1.5, mode="dense")
    assert_same_answers(want, dense)


def test_mode_dispatch_and_its_errors(shared):
    assert N < psuco.STREAMING_MIN_N == jsuco.STREAMING_MIN_N
    assert_equal(_port(shared, "plain", "auto"), _port(shared, "plain", "dense"))
    with pytest.raises(ValueError, match="unknown mode"):
        _port(shared, "plain", "bogus")
    for bad in (0, -5):
        with pytest.raises(ValueError, match="block_n"):
            _port(shared, "plain", "streaming", block_n=bad)
    for mode in ("dense", "streaming", "fused"):
        with pytest.raises(ValueError, match="k="):
            _port(shared, "plain", mode, k=N + 1)


def _fake_index(n, spec, sqrt_k, rng):
    """A structurally valid index over ``n`` points, for mode resolution."""
    h = spec.max_half_size
    c1 = rng.normal(size=(spec.n_subspaces, sqrt_k, h)).astype(np.float32)
    cells = rng.integers(0, sqrt_k * sqrt_k, size=(spec.n_subspaces, n)).astype(np.int32)
    counts = np.stack([np.bincount(c, minlength=sqrt_k * sqrt_k) for c in cells]).astype(np.int32)
    return c1, c1.copy(), cells, counts


@pytest.mark.parametrize("n", [psuco.STREAMING_MIN_N - 1, psuco.STREAMING_MIN_N])
def test_engine_auto_mode_resolves_as_the_reference(n):
    rng = np.random.default_rng(0)
    jspec = jsub.contiguous_spec(8, 2)
    c1, c2, cells, counts = _fake_index(n, jspec, 4, rng)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    jidx = jsuco.SuCoIndex(*map(jnp.asarray, (c1, c2, cells, counts)), spec=jspec, sqrt_k=4)
    jeng = jsuco.SuCoEngine(jnp.asarray(x), jidx, jsuco.EnginePolicy())
    pidx = psuco.SuCoIndex.from_numpy(c1, c2, cells, counts, spec=psuco.sub.contiguous_spec(8, 2),
                                      sqrt_k=4, device="cpu")
    peng = psuco.SuCoEngine(x, pidx, psuco.EnginePolicy(), device="cpu")
    assert peng.mode == jeng._mode == ("fused" if n >= psuco.STREAMING_MIN_N else "dense")
    for mode in ("dense", "streaming", "fused"):
        assert psuco.SuCoEngine(x, pidx, psuco.EnginePolicy(mode=mode), device="cpu").mode == mode
    with pytest.raises(ValueError, match="unknown mode"):
        psuco.SuCoEngine(x, pidx, psuco.EnginePolicy(mode="bogus"), device="cpu")
    with pytest.raises(ValueError, match="block_n"):
        psuco.SuCoEngine(x, pidx, psuco.EnginePolicy(block_n=0), device="cpu")


def test_engine_serves_every_mode_with_the_same_answers(shared):
    """The engine dispatches through ``suco_query``: each mode answers a
    padded batch the same, and only the fused mode synchronises with the
    host (one flag per chunk)."""
    x, idx, q = shared["x"], shared["p"]["tomb"], T(shared["q"][:5])  # bucket 8
    answers, syncs = {}, {}
    for mode in ("dense", "streaming", "fused"):
        policy = psuco.EnginePolicy(alpha=ALPHA, beta=BETA, mode=mode, block_n=1024,
                                    tiles=TileConfig(1024, survivor_cap=128))
        eng = psuco.SuCoEngine(x, idx, policy, device="cpu")
        answers[mode] = eng.query(q, K)
        single = eng.query(q[0], K)
        for a, b in zip(single, answers[mode]):
            assert torch.equal(a, b[0])
        st = eng.stats()
        assert st.batches == 2 and st.padded_queries == 3
        syncs[mode] = st.host_syncs
    assert_equal(answers["streaming"], answers["dense"])
    assert_equal(answers["fused"], answers["dense"])
    assert syncs == {"dense": 0, "streaming": 0, "fused": 2 * -(-N // 1024)}
