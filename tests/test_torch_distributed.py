"""The port's sharded SuCo engine (``repro_torch.distributed``) against the
JAX package's ``repro.distributed``, on the CPU.

The reference runs once per module in a subprocess with 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), at the sizes of
``tests/test_distributed.py``: ``gaussian_mixture`` 4,096 x 64, Ns = 8,
sqrt_k = 16, 6 Lloyd iterations, alpha 0.05, beta 0.02, k = 10, q_chunk
16, on a ``(2, 2, 2)`` mesh (pod, data, model) and a ``(2, 2)`` one (data,
model); it writes its builds and answers to an npz.  The port runs in 4
gloo processes on the ``(2, 2)`` mesh and in 8 on the ``(2, 2, 2)`` mesh,
one intra-op thread each, and each rank checks what ``tests/
test_distributed.py`` checks of the reference:

* the build from the same data: cell ids equal in at least 99.9% of
  places (the packages take squared distances by different arithmetic and
  sum over the ranks in another order, so points at a Voronoi boundary may
  go either way: the reference's own 1- and 8-device builds part at 10 of
  32,768), every subspace but at most one with all its cell ids equal, and
  there the centroids within ``rtol=1e-4, atol=1e-5`` and the counts
  equal; the counts the exact histogram of the port's cell ids;
* the query on the reference's own index: ids equal except where the
  reference's distances tie within ``rtol=2e-5``, distances within it;
* recall@10 of the port's own build at least 0.85 (the reference's floor);
* the streaming query (``block_n=300``, not a divisor of the 1,024- or
  2,048-point shards) against the dense one (``block_n=0``): equal bits;
* the chunked build (``build_block_n=300``) against the one-chunk build
  (``0``) at one Lloyd iteration and at six: equal bits;
* (8 ranks) the elastic move of the index from ``(2, 2, 2)`` to ``(4, 2)``
  (data, model): the same point and dim split, so the same answers bit for
  bit;
* the engine: ``warmup`` and a flat ``compile_count``, a padded batch, the
  artifact round trip (its file read again by the JAX package here);
* the pool's mixed-k replay, its answers against the single-device engine;
* ``kill_pool_engine``: the dead k-class rebound to k = 10, exact; a
  ``ValueError`` passing through; ``revive``.

Every subprocess has a time limit, so a hung rendezvous fails the test.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

_REFERENCE = textwrap.dedent(
    """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.distributed.engine import DistSuCoConfig, build_sharded, query_sharded, index_shardings
    from repro.data import make_dataset

    out = {}
    ds = make_dataset("gaussian_mixture", 4096, 64, m=16, k=10)
    out["x"], out["q"], out["gt"] = ds.x, ds.queries, ds.gt_ids
    devs = np.array(jax.devices())
    for world, shape, names, pa in ((8, (2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
                                    (4, (2, 2), ("data", "model"), ("data",))):
        mesh = Mesh(devs[:world].reshape(shape), names)
        cfg = DistSuCoConfig(n_subspaces=8, sqrt_k=16, kmeans_iters=6, alpha=0.05, beta=0.02,
                             k=10, q_chunk=16, point_axes=pa)
        sh = index_shardings(mesh, cfg)
        x = jax.device_put(jnp.asarray(ds.x), sh["x"])
        q = jax.device_put(jnp.asarray(ds.queries), sh["queries"])
        idx = build_sharded(mesh, x, cfg)
        ids, dists = query_sharded(mesh, cfg, x, idx, q)
        for name in ("centroids1", "centroids2", "cell_ids", "cell_counts"):
            out[f"w{world}_{name}"] = np.asarray(getattr(idx, name))
        out[f"w{world}_ids"], out[f"w{world}_dists"] = np.asarray(ids), np.asarray(dists)
    np.savez(sys.argv[1], **out)
    """
)

_WORKER = textwrap.dedent(
    """
    import dataclasses, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch import EnginePolicy, SuCoEngine
    from repro_torch.core.subspace import contiguous_spec
    from repro_torch.data import recall
    from repro_torch.distributed import (
        DistSuCoConfig, Mesh, ShardedEnginePool, ShardedSuCoEngine, build_sharded,
        index_from_host, index_to_host, query_sharded, reshard_index,
    )
    from repro_torch.serve.chaos import kill_pool_engine

    rank, world, init, ref_path, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                            sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    ref = dict(np.load(ref_path))
    tag = f"w{world}"
    if world == 8:
        mesh, pa = Mesh((2, 2, 2), ("pod", "data", "model")), ("pod", "data")
    else:
        mesh, pa = Mesh((2, 2), ("data", "model")), ("data",)
    cfg = DistSuCoConfig(n_subspaces=8, sqrt_k=16, kmeans_iters=6, alpha=0.05, beta=0.02, k=10,
                         q_chunk=16, point_axes=pa)
    x, q = torch.from_numpy(ref["x"]), torch.from_numpy(ref["q"])
    out = {}

    # the build from the same data
    idx = build_sharded(mesh, x, cfg, device="cpu")
    host = index_to_host(idx)
    out.update({f"build_{k}": v for k, v in host.items()})
    for k in range(8):
        assert np.array_equal(host["cell_counts"][k],
                              np.bincount(host["cell_ids"][k], minlength=256)), k
    ids, dists = query_sharded(mesh, cfg, x, idx, q)
    r = recall(ids.numpy(), ref["gt"])
    assert r >= 0.85, f"distributed recall too low: {r}"
    out["own_ids"] = ids.numpy()

    # the query on the reference's own index
    spec = contiguous_spec(64, 8)
    ridx = index_from_host({k: ref[f"{tag}_{k}"] for k in host}, spec, 16, mesh, cfg,
                           device="cpu")
    ids_r, dists_r = query_sharded(mesh, cfg, x, ridx, q)
    out["ids"], out["dists"] = ids_r.numpy(), dists_r.numpy()

    # streaming (blocked) against dense per-shard scoring: equal bits
    ids_d, dists_d = query_sharded(mesh, dataclasses.replace(cfg, block_n=0), x, ridx, q)
    ids_b, dists_b = query_sharded(mesh, dataclasses.replace(cfg, block_n=300), x, ridx, q)
    assert torch.equal(ids_d, ids_b) and torch.equal(dists_d, dists_b), "streaming != dense"
    assert torch.equal(ids_d, ids_r) and torch.equal(dists_d, dists_r), "autotuned != dense"

    # the chunked build against the one-chunk build: equal bits at 1 and 6 iterations
    for iters in (1, 6):
        c = dataclasses.replace(cfg, kmeans_iters=iters)
        a = index_to_host(build_sharded(mesh, x, dataclasses.replace(c, build_block_n=0),
                                        device="cpu"))
        b = index_to_host(build_sharded(mesh, x, dataclasses.replace(c, build_block_n=300),
                                        device="cpu"))
        for k in a:
            assert np.array_equal(a[k], b[k]), (iters, k)
    assert all(np.array_equal(b[k], host[k]) for k in host), "6 iterations != the default build"

    # elastic: the same split on a (4, 2) mesh answers the same, bit for bit
    if world == 8:
        mesh2 = Mesh((4, 2), ("data", "model"))
        cfg2 = dataclasses.replace(cfg, point_axes=("data",))
        idx2 = reshard_index(mesh2, cfg2, ridx)
        ids3, dists3 = query_sharded(mesh2, cfg2, x, idx2, q)
        assert torch.equal(ids3, ids_r) and torch.equal(dists3, dists_r), "elastic reshard"
        assert all(np.array_equal(v, index_to_host(idx2)[k])
                   for k, v in index_to_host(ridx).items())

    # the engine: warmed buckets never add a step, a partial batch pads
    eng = ShardedSuCoEngine(mesh, cfg, x, ridx, device="cpu")
    n_warm = eng.warmup(batch_sizes=(1, 16))
    assert n_warm == 2, n_warm
    ids_e, _ = eng.query(q)
    assert eng.compile_count == n_warm, "sharded engine added a step after warmup"
    assert torch.equal(ids_e, ids_r), "engine != query_sharded"
    ids_p, _ = eng.query(q[:3])
    assert torch.equal(ids_p, ids_r[:3]), "padded batch"
    art = f"{out_dir}/idx.npz"
    eng.save(art)
    eng2 = ShardedSuCoEngine.from_artifact(art, mesh, cfg, x, device="cpu")
    assert torch.equal(eng2.query(q)[0], ids_r), "artifact round trip"

    # the pool: per-k engines over one placed (x, index)
    pool = ShardedEnginePool(mesh, cfg, x, ridx, ks=(5, 10), device="cpu")
    p_warm = pool.warmup(batch_sizes=(1, 16))
    assert pool.ks == (5, 10) and p_warm == 4
    for mq_r, k_r in ((16, 10), (1, 5), (16, 5), (1, 10), (16, 10)):
        ids_k, dists_k = pool.query(q[:mq_r], k_r)
        assert ids_k.shape == (mq_r, k_r), (ids_k.shape, mq_r, k_r)
    assert pool.compile_count == p_warm, "pool added a step under mixed-k replay"
    assert torch.equal(pool.query(q, 10)[0], ids_r), "pool != query_sharded"
    leng = SuCoEngine(x, ridx.gather(), EnginePolicy(alpha=0.05, beta=0.02), device="cpu")
    for k_r in (5, 10):
        ids_k = pool.query(q, k_r)[0].numpy()
        ids_l = leng.query(q, k_r).ids.numpy()
        ov = np.mean([len(set(ids_k[i]) & set(ids_l[i])) / k_r for i in range(16)])
        assert ov >= 0.9, f"pool k={k_r} disagrees with the local engine: {ov}"

    # a dead k-class rebinds, exactly; ValueError passes through; revive
    ids10 = pool.query(q, 10)[0]
    _, _, info = pool.query_resilient(q, 5)
    assert info == {"degraded": False, "served_by": 5, "reason": ""}
    kill_pool_engine(pool, 5)
    ids_rb, _, info = pool.query_resilient(q, 5)
    assert info["degraded"] and info["served_by"] == 10, info
    assert "k=5" in info["reason"] and "rebound" in info["reason"]
    assert torch.equal(ids_rb, ids10[:, :5]), "rebind not exact"
    assert pool.dead_ks == (5,)
    try:
        pool.query_resilient(q, x.shape[0] + 1)
        raise AssertionError("ValueError expected for a malformed k")
    except ValueError:
        pass
    assert pool.dead_ks == (5,), "malformed input must not kill an engine"
    assert pool.compile_count == p_warm, "rebound serving added a step"
    pool.revive(5)
    assert pool.dead_ks == ()
    assert not pool.query_resilient(q, 5)[2]["degraded"], "a revived k serves primary again"

    if rank == 0:
        np.savez(f"{out_dir}/port.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    """
)

TIMEOUT = 240


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def _run_ranks(world: int, ref_path: Path, out_dir: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    logs = [open(out_dir / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), f"file://{out_dir / 'rdv'}",
         str(ref_path), str(out_dir)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        rcs = [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r}\n{f.read()[-2000:]}")
        f.close()
    assert rcs == [0] * world, "\n".join(text)
    return dict(np.load(out_dir / "port.npz"))


@pytest.fixture(scope="module", params=[4, 8], ids=["mesh2x2", "mesh2x2x2"])
def port(request, reference, tmp_path_factory):
    ref_path = tmp_path_factory.mktemp("refcopy") / "ref.npz"
    np.savez(ref_path, **reference)
    out_dir = tmp_path_factory.mktemp(f"port{request.param}")
    return request.param, _run_ranks(request.param, ref_path, out_dir), out_dir


def test_build_matches_the_reference_build(reference, port):
    """Cell ids within the Voronoi bound; each subspace whose cell ids all
    agree has the reference's centroids within tolerance and its counts
    exactly (a point that goes the other way at a boundary moves its
    centroids by its share of them, and Lloyd carries that on)."""
    world, got, _ = port
    cells, want = got["build_cell_ids"], reference[f"w{world}_cell_ids"]
    assert cells.shape == want.shape == (8, 4096) and cells.dtype == np.int32
    assert (cells == want).mean() >= 0.999
    same = (cells == want).all(axis=1)
    assert same.sum() >= 7, same
    for name in ("centroids1", "centroids2"):
        np.testing.assert_allclose(got[f"build_{name}"][same], reference[f"w{world}_{name}"][same],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got["build_cell_counts"][same],
                                  reference[f"w{world}_cell_counts"][same])


def test_query_on_the_reference_index_matches(reference, port):
    world, got, _ = port
    wi, wd = reference[f"w{world}_ids"], reference[f"w{world}_dists"]
    gi, gd = got["ids"], got["dists"]
    assert gi.shape == wi.shape == (16, 10) and gi.dtype == np.int32
    rtol = 2e-5
    np.testing.assert_allclose(gd, wd, rtol=rtol)
    for r in range(wi.shape[0]):
        for c in np.flatnonzero(wi[r] != gi[r]):
            tied = np.abs(wd[r] - wd[r, c]) <= rtol * wd[r, c]
            assert tied.sum() > 1, (r, c)


def test_own_build_reaches_the_recall_floor(reference, port):
    _, got, _ = port
    hits = [len(set(got["own_ids"][i]) & set(reference["gt"][i])) for i in range(16)]
    assert np.sum(hits) / (16 * 10) >= 0.85


def test_saved_artifact_loads_in_the_jax_package_bit_for_bit(reference, port):
    """The engine served the reference's index; its ``save`` (gathered,
    written by rank 0) is the JAX package's artifact of that index."""
    from repro.core.suco import load_index_artifact

    world, _, out_dir = port
    jidx, _ = load_index_artifact(out_dir / "idx.npz")
    for name in ("centroids1", "centroids2", "cell_ids", "cell_counts"):
        got, want = np.asarray(getattr(jidx, name)), reference[f"w{world}_{name}"]
        assert got.dtype == want.dtype and np.array_equal(got, want), name
