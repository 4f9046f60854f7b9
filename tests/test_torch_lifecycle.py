"""The port's SuCo index lifecycle against the JAX package's, on the CPU:
the four build modes, live insert and delete on an index and on a mutable
engine, and the ``.npz`` artifact both ways.

Tolerances: insert assignments and every count exactly, on integer-valued
points and centroids (both arithmetics are exact there); the engine's
answers after the same insert / delete sequence with ids and scores equal
and distances within ``rtol=2e-5`` (fp32 sums in another order); builds fed
the JAX package's own draws with centroids within ``1e-5`` and at most
0.1% of cell ids differing (a point on a Voronoi boundary can flip between
the two distance arithmetics).  Artifacts round-trip bit for bit.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import kmeans as jkm
from repro.core import subspace as jsub
from repro.core import suco as jsuco

from repro_torch.core import suco as psuco
from repro_torch.core.tuning import TileConfig
from repro_torch.data import exact_knn, gaussian_mixture, make_queries, recall

T = torch.from_numpy
K = 10


def _integer_index(n=6000, d=32, ns=4, sqrt_k=8, seed=0):
    """Integer-valued data, and a JAX index over it whose centroids are
    rounded to integers: every distance of an insert is exact in both
    packages, so their assignments agree bit for bit."""
    x = np.round(gaussian_mixture(n, d, seed, spread=3.0))
    cfg = jsuco.SuCoConfig(n_subspaces=ns, sqrt_k=sqrt_k, kmeans_iters=3, build_mode="chunked",
                           block_n=2048)
    jidx = jsuco.build_index(jnp.asarray(x), cfg)
    jidx = dataclasses.replace(jidx, centroids1=jnp.round(jidx.centroids1),
                               centroids2=jnp.round(jidx.centroids2))
    return x, cfg, jidx


def _port(jidx, device="cpu"):
    return psuco.SuCoIndex.from_numpy(
        *(np.asarray(a) for a in (jidx.centroids1, jidx.centroids2, jidx.cell_ids,
                                  jidx.cell_counts)),
        spec=psuco.sub.SubspaceSpec(jidx.spec.d, jidx.spec.n_subspaces, jidx.spec.perm,
                                    jidx.spec.bounds),
        sqrt_k=jidx.sqrt_k,
        tombstone=None if jidx.tombstone is None else np.asarray(jidx.tombstone),
        device=device,
    )


def _assert_index_equal(pidx, jidx):
    for name in ("centroids1", "centroids2", "cell_ids", "cell_counts", "tombstone"):
        want = getattr(jidx, name)
        got = getattr(pidx, name)
        if want is None:
            assert got is None, name
        else:
            np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want), err_msg=name)


# --------------------------------------------------------------------------
# Build modes
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_ds():
    """The reference's ``tests/test_kmeans_streaming.py`` data set."""
    x = gaussian_mixture(4000, 48, 0)
    q = make_queries(x, 8, seed=1)
    return x, q, exact_knn(x, q, K)[0]


def _spy_kmeans(monkeypatch):
    seen = []
    real = psuco.kmeans_batched

    def spy(*args, **kw):
        seen.append(dict(algo=kw["algo"], block_n=kw["block_n"]))
        return real(*args, **kw)

    monkeypatch.setattr(psuco, "kmeans_batched", spy)
    return seen


def test_default_config_builds_dense_below_the_streaming_cutover(monkeypatch, small_ds):
    """``SuCoConfig()`` is build_mode "auto": dense (block_n 0) below
    STREAMING_MIN_N points, chunked from it on, as the reference."""
    seen = _spy_kmeans(monkeypatch)
    x = T(small_ds[0][:3000, :16])
    cfg = psuco.SuCoConfig(n_subspaces=4, sqrt_k=8, kmeans_iters=2)
    assert cfg.build_mode == "auto" and psuco.SuCoConfig().build_mode == "auto"
    auto = psuco.build_index(x, cfg)
    dense = psuco.build_index(x, dataclasses.replace(cfg, build_mode="dense"))
    assert seen == [dict(algo="lloyd", block_n=0)] * 2
    for a, b in zip((auto.centroids1, auto.cell_ids), (dense.centroids1, dense.cell_ids)):
        assert torch.equal(a, b)
    big = T(np.tile(small_ds[0][:, :16], (9, 1)))[: psuco.STREAMING_MIN_N]
    psuco.build_index(big, dataclasses.replace(cfg, kmeans_iters=1))
    assert seen[-1] == dict(algo="lloyd", block_n=4096)
    psuco.build_index(x, dataclasses.replace(cfg, build_mode="minibatch", block_n=0))
    assert seen[-1]["algo"] == "minibatch" and seen[-1]["block_n"] > 0  # autotuned sample


def test_build_chunked_matches_dense(small_ds):
    x = T(small_ds[0])
    base = psuco.SuCoConfig(n_subspaces=8, sqrt_k=24, kmeans_iters=8, seed=0)
    dense = psuco.build_index(x, dataclasses.replace(base, build_mode="dense"))
    for block_n in (512, 1000):
        chunk = psuco.build_index(x, dataclasses.replace(base, build_mode="chunked",
                                                          block_n=block_n))
        assert (chunk.cell_ids == dense.cell_ids).float().mean() >= 0.999
        for a, b in ((dense.centroids1, chunk.centroids1), (dense.centroids2, chunk.centroids2)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_build_minibatch_quality(small_ds):
    """The reference's floor for a minibatch-built index: recall@10 >= 0.9."""
    x, q, gt = small_ds
    cfg = psuco.SuCoConfig(n_subspaces=8, sqrt_k=24, kmeans_iters=24, seed=0,
                           build_mode="minibatch", block_n=512)
    idx = psuco.build_index(T(x), cfg)
    for i in range(8):
        assert torch.equal(idx.cell_counts[i],
                           torch.bincount(idx.cell_ids[i].long(), minlength=576).int())
    res = psuco.suco_query(T(x), idx, T(q), k=K, alpha=0.05, beta=0.02)
    assert recall(res.ids.numpy(), gt) >= 0.9


@pytest.mark.parametrize("mode", ["dense", "minibatch"])
def test_build_matches_jax_with_its_draws(mode):
    """The JAX package's initial centroids (and minibatch samples) injected
    into the port's build of the same data."""
    n, d, ns, sk, iters, block_n = 6000, 32, 4, 12, 6, 1024
    x = gaussian_mixture(n, d, 3)
    cfg = jsuco.SuCoConfig(n_subspaces=ns, sqrt_k=sk, kmeans_iters=iters, build_mode=mode,
                           block_n=block_n)
    spec = jsub.contiguous_spec(d, ns)
    h1, h2 = jsub.split_halves_padded(spec, jsub.permute(spec, jnp.asarray(x)))
    key = jax.random.key(cfg.seed)
    algo = "minibatch" if mode == "minibatch" else "lloyd"
    seeds = np.asarray(jkm._init_batched(key, jnp.concatenate([h1, h2]), sk, "auto", algo))
    sample = None
    if mode == "minibatch":
        sample = T(np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key, t),
                                                           (block_n,), 0, n))
                             for t in range(iters)]))
    jidx = jsuco.build_index(jnp.asarray(x), cfg)
    pcfg = psuco.SuCoConfig(n_subspaces=ns, sqrt_k=sk, kmeans_iters=iters, build_mode=mode,
                            block_n=block_n)
    pidx = psuco.build_index(T(x), pcfg, init_centroids=T(seeds), sample_idx=sample)
    for a, b in ((jidx.centroids1, pidx.centroids1), (jidx.centroids2, pidx.centroids2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    assert (pidx.cell_ids.numpy() == np.asarray(jidx.cell_ids)).mean() >= 0.999
    for i in range(ns):
        np.testing.assert_array_equal(pidx.cell_counts[i].numpy(),
                                      np.bincount(pidx.cell_ids[i].numpy(), minlength=sk * sk))


def test_build_mode_validation():
    x = T(gaussian_mixture(500, 16, 0))
    with pytest.raises(ValueError, match="build_mode"):
        psuco.build_index(x, psuco.SuCoConfig(build_mode="bogus"))
    with pytest.raises(ValueError, match="block_n"):
        psuco.build_index(x, psuco.SuCoConfig(build_mode="chunked", block_n=-1))
    with pytest.raises(ValueError, match="block_n"):
        psuco.build_index(x, psuco.SuCoConfig(build_mode="minibatch", block_n=-1))


# --------------------------------------------------------------------------
# Insert and delete on an index
# --------------------------------------------------------------------------


def test_index_insert_and_delete_match_jax_exactly():
    x, _, jidx = _integer_index()
    new = np.round(gaussian_mixture(1500, 32, 9, spread=3.0))
    pidx = _port(jidx)
    assert pidx.memory_bytes() == jidx.memory_bytes()
    jcells, jdelta, jin = jsuco.assign_points(
        jnp.asarray(new), jidx.centroids1, jidx.centroids2, spec=jidx.spec, sqrt_k=jidx.sqrt_k,
        block_n=700)
    pcells, pdelta, pin = psuco.assign_points(
        T(new), pidx.centroids1, pidx.centroids2, spec=pidx.spec, sqrt_k=pidx.sqrt_k,
        block_n=700)
    np.testing.assert_array_equal(pcells.numpy(), np.asarray(jcells))
    np.testing.assert_array_equal(pdelta.numpy(), np.asarray(jdelta))
    assert float(pin) == float(jin)  # integer distances: exact sums
    jidx, pidx = jidx.insert(jnp.asarray(new), block_n=700), pidx.insert(new, block_n=700)
    _assert_index_equal(pidx, jidx)
    assert pidx.n_points == 7500 and pidx.tombstone is None
    dead = np.random.default_rng(2).choice(7500, 900, replace=False)
    jidx, pidx = jidx.delete(dead), pidx.delete(T(dead))
    _assert_index_equal(pidx, jidx)
    assert pidx.n_live == 6600
    again = pidx.delete(np.concatenate([dead[:5], dead[:5]]))  # idempotent, duplicates fine
    _assert_index_equal(again, jidx)
    jidx, pidx = jidx.insert(jnp.asarray(new[:10])), pidx.insert(new[:10])  # extends the mask
    _assert_index_equal(pidx, jidx)
    for bad in ([-1], [7510], [3, 7510]):
        with pytest.raises(ValueError, match="ids must be in"):
            pidx.delete(bad)
    assert pidx.delete([]) is pidx
    with pytest.raises(ValueError, match="points must be"):
        pidx.insert(np.zeros((3, 31), np.float32))


# --------------------------------------------------------------------------
# The mutable engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fused", "dense"])
def test_engine_mutation_sequence_matches_jax(mode):
    x, _, jidx = _integer_index()
    new = np.round(gaussian_mixture(3000, 32, 11, spread=3.0))
    q = np.round(make_queries(x, 8, seed=3) * 4) / 4
    jeng = jsuco.SuCoEngine(jnp.asarray(x), jidx, jsuco.EnginePolicy(
        mode=mode, block_n=1024, tiles=jsuco.TileConfig(block_n=2048, survivor_cap=128)),
        capacity=10_000)
    peng = psuco.SuCoEngine(x, _port(jidx), psuco.EnginePolicy(
        mode=mode, block_n=1024, tiles=TileConfig(block_n=2048, survivor_cap=128)),
        capacity=10_000, device="cpu")
    assert peng.capacity == 10_000 and peng.free_slots == 4_000 and peng.n_live == 6_000
    assert peng.mode == mode and peng.n_points == 10_000
    assert peng.warmup(batch_sizes=(3, 8)) == 2
    rng = np.random.default_rng(4)
    for step in range(3):
        batch = new[step * 1000:(step + 1) * 1000]
        np.testing.assert_array_equal(peng.insert(batch), jeng.insert(jnp.asarray(batch)))
        dead = rng.choice(6000 + (step + 1) * 1000, 400, replace=False)
        assert peng.delete(dead) == jeng.delete(dead)
        _assert_index_equal(peng.index, jeng.index)
        np.testing.assert_array_equal(peng.x.numpy(), np.asarray(jeng.x))
        assert peng.n_live == jeng.n_live and peng.free_slots == jeng.free_slots
        for m in (3, 8):
            want = jeng.query(jnp.asarray(q[:m]), K)
            got = peng.query(T(q[:m]), K)
            np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
            np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
            np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=2e-5)
            assert peng.index.tombstone[got.ids.long()].sum() == 0
    np.testing.assert_allclose(peng.insert_inertia_per_point, jeng.insert_inertia_per_point,
                               rtol=1e-6)
    # a deleted point's own query no longer finds it; an inserted one finds itself
    own = peng.query(T(new[2500]), K)
    assert int(own.ids[0]) == 6000 + 2500 and float(own.dists[0]) == 0.0
    assert peng.warmup(batch_sizes=(3, 8)) == 0  # no (bucket, k) pair is new


def test_engine_capacity_immutability_and_swap():
    x, _, jidx = _integer_index(n=2000)
    pidx = _port(jidx)
    with pytest.raises(ValueError, match="capacity"):
        psuco.SuCoEngine(x, pidx, capacity=1999, device="cpu")
    imm = psuco.SuCoEngine(x, pidx, device="cpu")
    assert imm.capacity is None and imm.free_slots == 0
    for op in (lambda: imm.insert(x[:2]), lambda: imm.delete([0])):
        with pytest.raises(ValueError, match="mutable engine"):
            op()
    eng = psuco.SuCoEngine(x, pidx, capacity=2100, device="cpu")
    counts_before = pidx.cell_counts.clone()
    eng.insert(x[:60])
    with pytest.raises(psuco.CapacityError, match="exceeds capacity"):
        eng.insert(x[:41])
    assert eng.free_slots == 40 and eng.insert(x[:40]).tolist() == list(range(2060, 2100))
    assert eng.delete(range(2050, 2100)) == 50 and eng.delete([2099]) == 0
    assert torch.equal(pidx.cell_counts, counts_before)  # the caller's index is never written
    assert eng.insert_inertia_per_point > 0 and imm.insert_inertia_per_point == 0.0
    eng.query(x[:3], K)
    succ = psuco.SuCoEngine(x, pidx, capacity=3000, device="cpu")
    with pytest.raises(ValueError, match="not warmed"):
        eng.swap(succ)
    succ.warmup(batch_sizes=(3,))
    eng.swap(succ)
    assert eng.capacity == 3000 and eng.free_slots == 1000 and eng.n_live == 2000
    assert eng._retired is not None
    eng.release_retired()
    assert eng._retired is None
    eng.swap(eng)  # a no-op


# --------------------------------------------------------------------------
# Artifacts
# --------------------------------------------------------------------------


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_artifact_of_a_jax_minibatch_build_keeps_its_config_and_extras(tmp_path):
    """The repair: the port read a JAX artifact's config without its
    build_mode (a minibatch build came back as chunked Lloyd) and dropped
    the extras."""
    x = gaussian_mixture(3000, 16, 5)
    cfg = jsuco.SuCoConfig(n_subspaces=4, sqrt_k=8, kmeans_iters=3, build_mode="minibatch",
                           block_n=512)
    jidx = jsuco.build_index(jnp.asarray(x), cfg).delete(np.arange(0, 3000, 7))
    extras = dict(keys=np.arange(3000, dtype=np.int64) * 3, wal_hwm=np.asarray(17, np.int64))
    path = tmp_path / "j.npz"
    jidx.save(path, cfg, extras=extras)
    pidx, pcfg, pextras = psuco.load_index_artifact(path, device="cpu", return_extras=True)
    assert pcfg == psuco.SuCoConfig(n_subspaces=4, sqrt_k=8, kmeans_iters=3,
                                    build_mode="minibatch", block_n=512)
    assert sorted(pextras) == ["keys", "wal_hwm"]
    for k, v in extras.items():
        assert pextras[k].dtype == v.dtype
        np.testing.assert_array_equal(pextras[k], v)
    _assert_index_equal(pidx, jidx)
    assert psuco.load_index_artifact(path, device="cpu")[1] == pcfg  # 2-tuple by default
    assert len(psuco.load_index_artifact(path, device="cpu")) == 2


@pytest.mark.parametrize("tomb", [False, True])
def test_port_artifact_loads_in_jax_bit_identical(tmp_path, tomb):
    x, _, jidx = _integer_index(n=2500)
    pidx = _port(jidx)
    if tomb:
        pidx = pidx.delete(np.arange(0, 2500, 5))
    cfg = psuco.SuCoConfig(n_subspaces=4, sqrt_k=8, kmeans_iters=3, build_mode="dense",
                           block_n=0, seed=9)
    extras = dict(rows=x[:7], note=np.asarray("v"))
    path = tmp_path / "p.npz"
    pidx.save(path, cfg, extras=extras)
    jback, jcfg, jextras = jsuco.load_index_artifact(path, return_extras=True)
    _assert_index_equal(pidx, jback)
    assert jcfg == jsuco.SuCoConfig(**dataclasses.asdict(cfg))
    np.testing.assert_array_equal(jextras["rows"], x[:7])
    assert str(jextras["note"]) == "v"
    # the same payload, key for key and byte for byte, as the JAX writer's
    jpath = tmp_path / "j.npz"
    jback.save(jpath, jsuco.SuCoConfig(**dataclasses.asdict(cfg)), extras=extras)
    mine, theirs = _arrays(path), _arrays(jpath)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype and mine[k].tobytes() == theirs[k].tobytes(), k
    again = psuco.SuCoIndex.load(path, device="cpu")
    _assert_index_equal(again, jback)
    pidx.save(tmp_path / "plain.npz")  # no config, no extras
    assert psuco.load_index_artifact(tmp_path / "plain.npz", device="cpu")[1] is None


@pytest.mark.parametrize("where", ["savez", "replace"])
def test_failed_write_leaves_no_temp_file_and_the_artifact_unchanged(tmp_path, monkeypatch, where):
    _, _, jidx = _integer_index(n=2000)
    pidx = _port(jidx)
    path = tmp_path / "idx.npz"
    pidx.save(path)
    before = path.read_bytes()
    listing = sorted(os.listdir(tmp_path))

    def boom(*a, **k):
        raise OSError("disk full")

    if where == "savez":
        monkeypatch.setattr(psuco.np, "savez", boom)
    else:
        monkeypatch.setattr(psuco.os, "replace", boom)
    with pytest.raises(OSError, match="disk full"):
        pidx.delete([1, 2]).save(path)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == listing
    assert path.read_bytes() == before
