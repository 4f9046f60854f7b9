"""The port's numpy modules against the JAX package's, on the CPU.

``repro_torch.core.theory``, ``repro_torch.core.da_numpy`` and
``repro_torch.data.datasets`` are copies (the JAX package's cannot be
imported without JAX), so on the same inputs they must give the same
results bit for bit: the Theorem 1 / 2 calculators on the cases of
``tests/test_theory.py``, the IMI traversals on the cases of
``tests/test_dynamic_activation.py`` (and the same cell sets as the port's
``activate_cells_sorted`` / ``dynamic_activation_lax``), and the generators
the same arrays for the same seeds.
"""

import math

import numpy as np
import pytest
import torch

from repro.core import da_numpy as jda
from repro.core import theory as jtheory
from repro.data import datasets as jdata

from repro_torch.core import da_numpy as pda
from repro_torch.core import theory as ptheory
from repro_torch.core.suco import activate_cells_sorted, dynamic_activation_lax
from repro_torch.data import datasets as pdata


def assert_same(a, b):
    """Equal values of equal types, NaN equal to NaN (no tolerance)."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert_same(u, v)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            assert_same(a[key], b[key])
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b)
    else:
        assert a == b, (a, b)


# ---- theory: the cases of tests/test_theory.py ---------------------------

_GRID = [dict(n=n, k=k, n_subspaces=4, m=8.0, sigma=2.0, alpha=a)
         for n in (100, 10_000, 1_000_000) for k in (1, 10, n - 1)
         for a in (0.001, 0.05, 0.5, 0.99)]
THEOREM2 = [
    dict(n=100_000, k=50, n_subspaces=8, m=10.0, sigma=1.0, alpha=0.05),
    dict(n=1000, k=50, n_subspaces=8, m=10.0, sigma=1.0, alpha=0.999999),
    dict(n=100_000, k=1, n_subspaces=8, m=10.0, sigma=1.0, alpha=0.05),
    dict(n=10_000, k=10, n_subspaces=1, m=4.0, sigma=1.0, alpha=0.05),
    dict(n=10_000, k=10, n_subspaces=1, m=1.0, sigma=1.0, alpha=0.05),
    *[dict(n=100_000, k=50, n_subspaces=8, m=10.0, sigma=1.0, alpha=a) for a in (0.02, 0.2)],
    dict(n=1000, k=999, n_subspaces=8, m=10.0, sigma=1.0, alpha=0.05),
    *_GRID,
]


@pytest.mark.parametrize("p", [0.5, 0.975, 0.025, 1e-9, 0.01, 0.9999])
def test_ndtri_is_the_references(p):
    assert_same(ptheory._ndtri(p), jtheory._ndtri(p))
    assert ptheory._ndtri(0.975) == pytest.approx(1.959964, abs=1e-5)


def test_ndtri_refuses_outside_the_unit_interval():
    for p in (0.0, 1.0):
        with pytest.raises(ValueError):
            ptheory._ndtri(p)


@pytest.mark.parametrize("m,sigma,ns,alpha", [
    (10.0, 1.0, 8, 0.95), (10.0, 1.0, 8, 1e-4),
    *[(r, 1.0, ns, a) for r in (2.0, 7.5, 50.0) for ns in (4, 16) for a in (0.7, 0.95)],
])
def test_theorem1_is_the_references(m, sigma, ns, alpha):
    got = ptheory.theorem1_bound(m, sigma, ns, alpha)
    assert_same(tuple(got), tuple(jtheory.theorem1_bound(m, sigma, ns, alpha)))
    assert type(got).__name__ == "GuaranteeReport"
    if alpha == 0.95 and m == 10.0:
        assert got.success_prob >= 0.5 - 1.0 / math.e**2 - 1e-9


def test_theorem2_is_the_references():
    for kw in THEOREM2:
        got = ptheory.theorem2_bound(**kw)
        assert_same(got, jtheory.theorem2_bound(**kw))
        assert 0.0 <= got <= 1.0, kw
    assert ptheory.theorem2_bound(**THEOREM2[0]) >= 0.5
    assert ptheory.theorem2_bound(**THEOREM2[1]) == 0.0


def test_degraded_budget_bound_is_the_references():
    common = dict(n=48_000, k=10, n_subspaces=8, m=8.0, sigma=2.0)
    for alpha in (0.05, 0.032):
        for beta in (0.02, 0.01, 0.005, 0.001, 10 / (2 * 48_000), 0.0, -0.1):
            got = ptheory.degraded_budget_bound(alpha=alpha, beta=beta, **common)
            assert_same(got, jtheory.degraded_budget_bound(alpha=alpha, beta=beta, **common))
    assert ptheory.degraded_budget_bound(alpha=0.05, beta=10 / (2 * 48_000), **common) == 0.0


def test_statistics_and_suggestion_are_the_references():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, 64)).astype(np.float32)
    q = rng.normal(size=64).astype(np.float32)
    got = ptheory.subspace_statistics(x, q, 8)
    assert_same(got, jtheory.subspace_statistics(x, q, 8))
    kw = dict(n=100_000, d=64, k=50, m=got[0], sigma=got[1])
    assert_same(ptheory.suggest_parameters(**kw), jtheory.suggest_parameters(**kw))
    # no grid point reaches the target: the fallback dict
    kw = dict(n=1000, d=64, k=999, m=1.0, sigma=1.0)
    assert_same(ptheory.suggest_parameters(**kw), jtheory.suggest_parameters(**kw))
    x = rng.standard_normal((4096, 32)).astype(np.float32)
    for seed in (3, 4):
        assert_same(ptheory.estimate_subspace_statistics(x, 8, seed=seed),
                    jtheory.estimate_subspace_statistics(x, 8, seed=seed))
    small = x[:5]  # fewer rows than either sample asks for
    assert_same(ptheory.estimate_subspace_statistics(small, 4, seed=1),
                jtheory.estimate_subspace_statistics(small, 4, seed=1))


# ---- da_numpy: the cases of tests/test_dynamic_activation.py -------------


def imi_cases(n_cases: int = 60):
    """(dists1, dists2, counts, target) as ``imi_case`` draws them."""
    draw = np.random.default_rng(2024)
    for _ in range(n_cases):
        k = int(draw.integers(2, 13))
        rng = np.random.default_rng(int(draw.integers(0, 2**31 - 1)))
        d1 = rng.random(k).astype(np.float64)
        d2 = rng.random(k).astype(np.float64)
        counts = rng.integers(0, 10, size=(k, k)).astype(np.int32)
        total = int(counts.sum())
        yield d1, d2, counts, int(draw.integers(1, max(total, 1) + 1))


@pytest.mark.parametrize("case", list(imi_cases()), ids=lambda c: f"k{len(c[0])}-t{c[3]}")
def test_traversals_are_the_references_and_the_ports_masks(case):
    d1, d2, counts, target = case
    ms = pda.multi_sequence(d1, d2, counts, target)
    da = pda.dynamic_activation(d1, d2, counts, target)
    assert ms == jda.multi_sequence(d1, d2, counts, target)
    assert da == jda.dynamic_activation(d1, d2, counts, target)
    assert ms == da
    k = counts.shape[1]
    cells = {c1 * k + c2 for c1, c2 in ms}
    flat = torch.from_numpy(counts.reshape(-1))
    t1, t2 = torch.from_numpy(d1), torch.from_numpy(d2)
    for fn in (activate_cells_sorted, dynamic_activation_lax):
        assert set(torch.nonzero(fn(t1, t2, flat, target)).flatten().tolist()) == cells
    # the minimal ascending-distance prefix covering the target
    got = sum(int(counts[c1, c2]) for c1, c2 in ms)
    if got < target:
        assert len(ms) == counts.size
    else:
        assert got - int(counts[ms[-1]]) < target


def test_multi_sequence_order_is_ascending_distance():
    rng = np.random.default_rng(0)
    d1, d2 = rng.random(8), rng.random(8)
    counts = np.ones((8, 8), np.int32)
    cells = pda.multi_sequence(d1, d2, counts, 64)
    assert cells == jda.multi_sequence(d1, d2, counts, 64)
    dists = [d1[a] + d2[b] for a, b in cells]
    assert all(x <= y + 1e-12 for x, y in zip(dists, dists[1:]))


# ---- datasets: the generators and metrics --------------------------------


@pytest.mark.parametrize("kind", sorted(jdata.GENERATORS))
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generators_give_the_references_arrays(kind, seed):
    assert sorted(pdata.GENERATORS) == sorted(jdata.GENERATORS)
    got = pdata.GENERATORS[kind](700, 24, seed)
    want = jdata.GENERATORS[kind](700, 24, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    q = pdata.make_queries(got, 9, seed + 1)
    np.testing.assert_array_equal(q, jdata.make_queries(want, 9, seed + 1))


@pytest.mark.parametrize("kind", ["gaussian_mixture", "uniform", "correlated", "zipf_mixture"])
def test_make_dataset_is_the_references(kind):
    got = pdata.make_dataset(kind, 1500, 16, m=7, k=5, seed=3)
    want = jdata.make_dataset(kind, 1500, 16, m=7, k=5, seed=3)
    assert isinstance(got, pdata.Dataset) and got.name == want.name
    for field in ("x", "queries", "gt_ids", "gt_dists"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_exact_knn_and_metrics_are_the_references():
    x = pdata.uniform(3000, 12, 5)
    q = pdata.make_queries(x, 6, 2)
    for metric in ("l2", "l1"):
        for block in (262_144, 1000):
            got = pdata.exact_knn(x, q, 8, metric=metric, block=block)
            want = jdata.exact_knn(x, q, 8, metric=metric, block=block)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pdata.exact_knn(x, q, 8, metric="cosine")
    ids, dists = pdata.exact_knn(x, q, 8)
    noisy = np.roll(ids, 1, axis=1)
    noisy[:, 0] = 0
    assert_same(pdata.recall(noisy, ids), jdata.recall(noisy, ids))
    assert_same(pdata.mean_relative_error(dists * 1.1, dists),
                jdata.mean_relative_error(dists * 1.1, dists))
    zero = np.zeros_like(dists)  # guarded zero ground truth
    assert_same(pdata.mean_relative_error(dists, zero), jdata.mean_relative_error(dists, zero))
