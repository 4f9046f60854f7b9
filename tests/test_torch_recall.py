"""The Theorem-2 recall floors of ``tests/test_recall.py``, applied to the port.

The same ``(kind, seed)`` cells (N = 4,000, D = 32, Ns = 8, sqrt_k = 16, 6
Lloyd iterations, 32 queries, k = 10) go through the port's own CPU build
and engine.  Each cell is held to the same ``theorem2_bound`` on the
success rate (the true nearest neighbour in the returned top-k), computed
by the JAX package's theory on the JAX package's dataset and equal to the
port's own, and to the same recall@10 floor; the dense, streaming and fused
modes and a bucket-padded engine must return the same ids.  The sharded
and nightly-sized cases wait for the port's sharded engine.
"""

import numpy as np
import pytest
import torch

from repro.core.theory import subspace_statistics as j_statistics
from repro.core.theory import theorem2_bound as j_theorem2
from repro.data import make_dataset as j_make_dataset

from repro_torch import EnginePolicy, SuCoConfig, SuCoEngine, build_index, suco_query
from repro_torch.core.theory import subspace_statistics, theorem2_bound
from repro_torch.data import make_dataset, recall

N, D, M, K = 4000, 32, 32, 10
NS, SQRT_K, ITERS = 8, 16, 6
PARAMS = {
    "gaussian_mixture": dict(alpha=0.05, beta=0.02, floor=0.95),
    "uniform": dict(alpha=0.10, beta=0.05, floor=0.60),
}
CASES = [(kind, seed) for kind in PARAMS for seed in (0, 1)]


def _bound(x, queries, alpha, stats=subspace_statistics, theorem2=theorem2_bound) -> float:
    per_query = [stats(x, q, NS) for q in queries]
    mean = float(np.mean([s[0] for s in per_query]))
    sigma = float(np.mean([s[1] for s in per_query]))
    return theorem2(N, K, NS, mean, sigma, alpha)


def _success_rate(ids: np.ndarray, gt_ids: np.ndarray) -> float:
    return float(np.mean([int(gt_ids[i, 0]) in set(map(int, ids[i])) for i in range(len(ids))]))


@pytest.fixture(scope="module")
def cells():
    """(dataset, the port's CPU index, bound, params) per (kind, seed)."""
    out = {}
    for kind, seed in CASES:
        ds = make_dataset(kind, N, D, m=M, k=K, seed=seed)
        index = build_index(torch.from_numpy(ds.x),
                            SuCoConfig(n_subspaces=NS, sqrt_k=SQRT_K, kmeans_iters=ITERS,
                                       seed=seed))
        p = PARAMS[kind]
        out[kind, seed] = (ds, index, _bound(ds.x, ds.queries, p["alpha"]), p)
    return out


@pytest.mark.parametrize("kind,seed", CASES)
def test_port_meets_the_theory_bound_and_recall_floor(cells, kind, seed):
    ds, index, bound, p = cells[kind, seed]
    jds = j_make_dataset(kind, N, D, m=M, k=K, seed=seed)
    assert bound == _bound(jds.x, jds.queries, p["alpha"], j_statistics, j_theorem2)
    assert 0.5 <= bound <= 1.0, f"vacuous theory bound {bound}"
    res = suco_query(torch.from_numpy(ds.x), index, torch.from_numpy(ds.queries),
                     k=K, alpha=p["alpha"], beta=p["beta"])
    ids = res.ids.numpy()
    succ = _success_rate(ids, ds.gt_ids)
    assert succ >= bound, f"{kind}/seed{seed}: success rate {succ} below theory bound {bound}"
    r = recall(ids, ds.gt_ids)
    assert r >= p["floor"], f"{kind}/seed{seed}: recall@{K} {r} below floor {p['floor']}"


@pytest.mark.parametrize("kind,seed", CASES)
def test_port_modes_report_identical_recall(cells, kind, seed):
    ds, index, _, p = cells[kind, seed]
    x, q = torch.from_numpy(ds.x), torch.from_numpy(ds.queries)
    results = {mode: suco_query(x, index, q, k=K, alpha=p["alpha"], beta=p["beta"], mode=mode)
               for mode in ("dense", "streaming", "fused")}
    engine = SuCoEngine(x, index, EnginePolicy(alpha=p["alpha"], beta=p["beta"],
                                               batch_buckets=(8, 32)), device="cpu")
    results["engine"] = engine.query(q[:20], K)  # padded to the bucket of 32
    recalls = {name: recall(r.ids.numpy(), ds.gt_ids[: len(r.ids)])
               for name, r in results.items()}
    assert recalls["dense"] == recalls["streaming"] == recalls["fused"], recalls
    for name in ("streaming", "fused"):
        np.testing.assert_array_equal(results["dense"].ids.numpy(), results[name].ids.numpy())
    np.testing.assert_array_equal(results["dense"].ids[:20].numpy(),
                                  results["engine"].ids.numpy())
