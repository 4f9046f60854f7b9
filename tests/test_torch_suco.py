"""The port's slice as a whole against the JAX package, on the CPU.

* **Build**: the JAX package's initial centroids are injected into the
  port's build (the two RNGs differ); centroids agree to ``rtol=1e-4``, cell
  ids in at least 99.9% of places (the JAX package's own chunked-vs-dense
  bound), and ``cell_counts`` is exactly the histogram of the port's cell ids.
* **Artifact**: the JAX package builds and saves an index; the port loads
  the ``.npz`` with the same magic, version and CRC32 checks.
* **Query**: both packages answer the same queries on that shared index
  with the same pinned tiling: the fused query and the engine, with and
  without a tombstone mask.  Ids must be equal except where distances tie
  within the tolerance, the scores of matching ids exactly equal, and the
  distances at each rank within ``rtol=2e-5`` (fp32 sums in another order).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import subspace as jsub
from repro.core import suco as jsuco
from repro.core.kmeans import _init_batched
from repro.core.tuning import TileConfig as JTiles

import repro_torch
from repro_torch.core import suco as psuco
from repro_torch.core.tuning import TileConfig as PTiles
from repro_torch.data import exact_knn, gaussian_mixture, make_queries, recall

N, D, NS, SQRT_K, ITERS = 20_000, 32, 8, 16, 6
ALPHA, BETA, K = 0.05, 0.02, 10
# (block_n, survivor_cap): one tiling whose small cap sends chunks down the
# exact overflow fallback, one that mostly takes the pruned merge
TILINGS = [(2048, 64), (4096, 256)]


def assert_same_answers(want, got, rtol=2e-5):
    """``want``: the JAX package's QueryResult, ``got``: the port's."""
    wi, wd, ws = (np.asarray(a) for a in want)
    gi, gd, gs = (a.cpu().numpy() for a in got)
    assert gi.shape == wi.shape and gi.dtype == np.int32 and gs.dtype == np.int32
    np.testing.assert_allclose(gd, wd, rtol=rtol)
    for r in range(wi.shape[0]):
        for c in np.flatnonzero(wi[r] != gi[r]):
            # a different id at this rank only where JAX's distances tie
            tied = np.abs(wd[r] - wd[r, c]) <= rtol * wd[r, c]
            assert tied.sum() > 1 or np.isclose(gd[r, c], wd[r, c], rtol=rtol), (r, c)
        w_scores = dict(zip(wi[r].tolist(), ws[r].tolist()))
        for i, s in zip(gi[r].tolist(), gs[r].tolist()):
            if i in w_scores:
                assert s == w_scores[i], (r, i)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Data, queries, and the JAX package's index saved as an artifact,
    plain and with a tombstone mask."""
    x = gaussian_mixture(N, D, 0)
    q = make_queries(x, 8, seed=1)
    cfg = jsuco.SuCoConfig(
        n_subspaces=NS, sqrt_k=SQRT_K, kmeans_iters=ITERS, build_mode="chunked", block_n=4096
    )
    jidx = jsuco.build_index(jnp.asarray(x), cfg)
    dead = np.random.default_rng(5).choice(N, N // 10, replace=False)
    paths = {}
    for name, idx in (("plain", jidx), ("tomb", jidx.delete(dead))):
        paths[name] = tmp_path_factory.mktemp("art") / f"{name}.npz"
        idx.save(paths[name], cfg)
    return dict(x=x, q=q, cfg=cfg, jidx=jidx, jtomb=jidx.delete(dead), paths=paths, dead=dead)


def test_build_matches_jax_with_injected_seeds():
    n, d, ns, sk, iters, block_n = 20_000, 32, 4, 16, 10, 4096
    x = gaussian_mixture(n, d, 0)
    spec = jsub.contiguous_spec(d, ns)
    cfg = jsuco.SuCoConfig(
        n_subspaces=ns, sqrt_k=sk, kmeans_iters=iters, build_mode="chunked", block_n=block_n
    )
    h1, h2 = jsub.split_halves_padded(spec, jsub.permute(spec, jnp.asarray(x)))
    both = jnp.concatenate([h1, h2], axis=0)
    seeds = np.asarray(_init_batched(jax.random.key(cfg.seed), both, sk, "auto", "lloyd"))
    jidx = jsuco.build_index(jnp.asarray(x), cfg)
    pidx = psuco.build_index(
        torch.from_numpy(x),
        psuco.SuCoConfig(n_subspaces=ns, sqrt_k=sk, kmeans_iters=iters, build_mode="chunked",
                         block_n=block_n),
        init_centroids=torch.tensor(seeds),
    )
    for a, b in ((jidx.centroids1, pidx.centroids1), (jidx.centroids2, pidx.centroids2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)
    cells = pidx.cell_ids.numpy()
    assert pidx.cell_ids.dtype == torch.int32 and cells.shape == (ns, n)
    assert (cells == np.asarray(jidx.cell_ids)).mean() >= 0.999
    for i in range(ns):
        np.testing.assert_array_equal(
            pidx.cell_counts[i].numpy(), np.bincount(cells[i], minlength=sk * sk)
        )


def test_build_is_deterministic_in_the_seed():
    x = torch.from_numpy(gaussian_mixture(3000, 16, 2))
    cfg = psuco.SuCoConfig(n_subspaces=4, sqrt_k=8, kmeans_iters=3, seed=7, block_n=1000)
    a, b = psuco.build_index(x, cfg), psuco.build_index(x, cfg)
    assert torch.equal(a.centroids1, b.centroids1) and torch.equal(a.cell_ids, b.cell_ids)
    c = psuco.build_index(x, dataclasses.replace(cfg, seed=8))
    assert not torch.equal(a.centroids1, c.centroids1)
    auto = psuco.build_index(x, dataclasses.replace(cfg, block_n=0))  # autotuned chunk
    assert auto.cell_counts.sum() == 4 * 3000


def test_artifact_carries_the_jax_index_over(shared):
    pidx, pcfg = psuco.load_index_artifact(shared["paths"]["plain"], device="cpu")
    jidx = shared["jidx"]
    for name in ("centroids1", "centroids2", "cell_ids", "cell_counts"):
        np.testing.assert_array_equal(getattr(pidx, name).numpy(), np.asarray(getattr(jidx, name)))
    assert (pidx.spec.perm, pidx.spec.bounds, pidx.sqrt_k) == (
        jidx.spec.perm, jidx.spec.bounds, jidx.sqrt_k
    )
    assert pidx.tombstone is None and pidx.n_live == N
    assert (pcfg.n_subspaces, pcfg.sqrt_k, pcfg.kmeans_iters, pcfg.block_n) == (NS, SQRT_K, ITERS, 4096)
    tidx, _ = psuco.load_index_artifact(shared["paths"]["tomb"], device="cpu")
    assert tidx.n_live == N - len(shared["dead"])
    np.testing.assert_array_equal(tidx.cell_counts.numpy(), np.asarray(shared["jtomb"].cell_counts))


def test_ranks_and_cuts_from_the_jax_centroid_distances_are_exact(shared):
    """The JAX package's own d1/d2 of real queries on its index, fed to the
    port's Dynamic Activation, give the JAX ranks and cuts exactly; the
    port's own centroid distances are the same bits."""
    jidx, q = shared["jidx"], jnp.asarray(shared["q"])
    count = jsub.collision_count(N, ALPHA)
    d1, d2 = jsuco._centroid_dists(jidx, q, "l2")
    want_r, want_c = jsuco.suco_cell_ranks(jidx, q, count)
    pidx, _ = psuco.load_index_artifact(shared["paths"]["plain"], device="cpu")
    got_r, got_c = psuco._cell_ranks_and_cut(
        torch.tensor(np.asarray(d1)), torch.tensor(np.asarray(d2)),
        pidx.cell_counts[:, None, :], count,
    )
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    p1, p2 = psuco._centroid_dists(pidx, torch.from_numpy(shared["q"]), "l2")
    np.testing.assert_array_equal(p1.numpy(), np.asarray(d1))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(d2))


def test_from_numpy_checks_the_layouts(shared):
    jidx = shared["jidx"]
    arrays = [np.asarray(a) for a in (jidx.centroids1, jidx.centroids2, jidx.cell_ids,
                                      jidx.cell_counts)]
    kw = dict(spec=psuco.sub.SubspaceSpec(jidx.spec.d, NS, jidx.spec.perm, jidx.spec.bounds),
              sqrt_k=SQRT_K, device="cpu")
    idx = psuco.SuCoIndex.from_numpy(*arrays, **kw)
    assert idx.cell_ids.dtype == torch.int32 and idx.centroids1.dtype == torch.float32
    for i, bad in enumerate((arrays[0][:, :-1], arrays[1][..., :1], arrays[2][:1],
                             arrays[3][:, :-1])):
        with pytest.raises(ValueError):
            psuco.SuCoIndex.from_numpy(*arrays[:i], bad, *arrays[i + 1:], **kw)
    with pytest.raises(ValueError, match="tombstone"):
        psuco.SuCoIndex.from_numpy(*arrays, tombstone=np.zeros(3, bool), **kw)


def _rewrite(src, dst, **changes):
    with np.load(src) as z:
        arrays = {k: z[k] for k in z.files}
    arrays.update(changes)
    for k in [k for k, v in changes.items() if v is None]:
        del arrays[k]
    with open(dst, "wb") as f:
        np.savez(f, **arrays)


@pytest.mark.parametrize("fault", ["foreign", "version", "missing", "bitflip", "truncated"])
def test_artifact_faults_raise_artifact_error(shared, tmp_path, fault):
    src, bad = shared["paths"]["plain"], tmp_path / "bad.npz"
    if fault == "foreign":
        np.savez(bad, x=np.zeros(3))
    elif fault == "version":
        _rewrite(src, bad, version=np.asarray(99, np.int32))
    elif fault == "missing":
        _rewrite(src, bad, cell_ids=None)
    elif fault == "bitflip":  # consistent zip, wrong content: only the CRC32 catches it
        with np.load(src) as z:
            c1 = z["centroids1"].copy()
        c1.flat[3] += 1.0
        _rewrite(src, bad, centroids1=c1)
    else:
        bad.write_bytes(src.read_bytes()[:200])
    with pytest.raises(psuco.ArtifactError):
        psuco.load_index_artifact(bad, device="cpu")
    if fault == "bitflip":
        with pytest.raises(psuco.ArtifactError, match="centroids1"):
            psuco.load_index_artifact(bad, device="cpu")


def test_artifact_versions_1_and_2_load(shared, tmp_path):
    with np.load(shared["paths"]["tomb"]) as z:
        arrays = {k: z[k] for k in z.files if not k.startswith("crc_")}
    for version in (1, 2):
        arrays["version"] = np.asarray(version, np.int32)
        path = tmp_path / f"v{version}.npz"
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        idx, _ = psuco.load_index_artifact(path, device="cpu")
        assert idx.n_live == N - len(shared["dead"])


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("tomb", [False, True])
def test_fused_query_matches_jax_on_the_shared_index(shared, tiling, tomb):
    jidx = shared["jtomb"] if tomb else shared["jidx"]
    pidx, _ = psuco.load_index_artifact(shared["paths"]["tomb" if tomb else "plain"], device="cpu")
    x, q = shared["x"], shared["q"]
    want = jsuco.suco_query_fused(
        jnp.asarray(x), jidx, jnp.asarray(q), k=K, alpha=ALPHA, beta=BETA,
        tiles=JTiles(block_n=tiling[0], survivor_cap=tiling[1]),
    )
    got = psuco.suco_query_fused(
        torch.from_numpy(x), pidx, torch.from_numpy(q), k=K, alpha=ALPHA, beta=BETA,
        tiles=PTiles(block_n=tiling[0], survivor_cap=tiling[1]),
    )
    assert_same_answers(want, got)
    if tomb:
        assert not np.isin(got.ids.numpy(), shared["dead"]).any()


def test_fused_query_l1_matches_jax(shared):
    pidx, _ = psuco.load_index_artifact(shared["paths"]["plain"], device="cpu")
    x, q = shared["x"], shared["q"][:3]
    kw = dict(k=K, alpha=ALPHA, beta=BETA, metric="l1")
    want = jsuco.suco_query_fused(
        jnp.asarray(x), shared["jidx"], jnp.asarray(q), tiles=JTiles(4096, survivor_cap=256), **kw
    )
    got = psuco.suco_query_fused(
        torch.from_numpy(x), pidx, torch.from_numpy(q), tiles=PTiles(4096, 256), **kw
    )
    assert_same_answers(want, got)


@pytest.mark.parametrize("tomb", [False, True])
def test_engine_matches_jax_engine(shared, tomb):
    x = shared["x"]
    jpol = jsuco.EnginePolicy(alpha=ALPHA, beta=BETA, mode="fused", tiles=JTiles(4096, survivor_cap=256))
    jeng = jsuco.SuCoEngine(jnp.asarray(x), shared["jtomb"] if tomb else shared["jidx"], jpol)
    path = shared["paths"]["tomb" if tomb else "plain"]
    peng = repro_torch.SuCoEngine.from_artifact(
        path, x,
        repro_torch.EnginePolicy(alpha=ALPHA, beta=BETA, mode="fused", tiles=PTiles(4096, 256)),
        device="cpu",
    )
    assert peng.warmup(batch_sizes=(1, 3, 8), ks=(K,)) == 3
    queries = make_queries(x, 8, seed=4)
    for m in (1, 3, 8):
        want = jeng.query(jnp.asarray(queries[:m]), K)
        got = peng.query(torch.from_numpy(queries[:m]), K)
        assert got.ids.device.type == "cpu"
        assert_same_answers(want, got)
    single = peng.query(queries[0], K)
    assert single.ids.shape == (K,)
    st = peng.stats()
    assert st.batches == 7 and st.queries == (1 + 4 + 8) + (1 + 3 + 8) + 1
    assert st.padded_queries == 1  # 3 queries -> bucket 4
    assert st.buckets == ((1, K), (4, K), (8, K))
    assert st.host_syncs == st.batches * -(-N // 4096)  # one per chunk
    with pytest.raises(ValueError):
        peng.query(queries[:2], peng.n_live + 1)


def test_engine_build_on_cpu_reaches_the_recall_floor():
    x = gaussian_mixture(4000, 32, 0)
    q = make_queries(x, 32, seed=1)
    eng = repro_torch.SuCoEngine.build(
        x, repro_torch.SuCoConfig(n_subspaces=8, sqrt_k=16, kmeans_iters=6), device="cpu"
    )
    res = eng.query(q, K)
    gt, _ = exact_knn(x, q, K)
    # the tests/test_recall.py floor for clustered data at alpha=0.05, beta=0.02
    assert recall(res.ids.numpy(), gt) >= 0.95
    assert res.ids.dtype == torch.int32 and res.scores.dtype == torch.int32
