"""Synthetic ANN datasets + exact ground truth + quality metrics.

The paper evaluates on SIFT/Deep/SPACEV/GIST etc.  Those corpora are not
available offline, so we provide parameterised generators that reproduce the
*structural* properties that matter for subspace collision:

* ``gaussian_mixture`` — clustered data, the regime of SIFT/Deep (low LID);
* ``correlated``       — anisotropic covariance (distance mass concentrated
  in a few dims — exactly the failure mode Figure 1 motivates);
* ``uniform``          — iid data, the hard/no-structure regime (high LID);
* ``zipf_mixture``     — heavily skewed cluster sizes (stress for the IMI).

Every generator is deterministic in ``seed`` and returns float32.  A copy
of the JAX package's ``repro.data.datasets`` (numpy only), which cannot be
imported without JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

__all__ = [
    "Dataset",
    "gaussian_mixture",
    "correlated",
    "uniform",
    "zipf_mixture",
    "make_queries",
    "exact_knn",
    "recall",
    "mean_relative_error",
    "GENERATORS",
]


@dataclasses.dataclass
class Dataset:
    name: str
    x: np.ndarray  # (n, d) float32
    queries: np.ndarray  # (m, d) float32
    gt_ids: np.ndarray  # (m, k) int64 exact NN ids
    gt_dists: np.ndarray  # (m, k) float32 exact squared L2


def uniform(n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


def gaussian_mixture(
    n: int, d: int, seed: int = 0, *, n_clusters: int = 256, spread: float = 5.0
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * spread
    who = rng.integers(0, n_clusters, n)
    return (centers[who] + rng.normal(size=(n, d))).astype(np.float32)


def correlated(n: int, d: int, seed: int = 0, *, decay: float = 0.9) -> np.ndarray:
    """Anisotropic data: variance decays geometrically across dims."""
    scales = decay ** np.arange(d)
    base = gaussian_mixture(n, d, seed, n_clusters=128)
    return (base * scales[None, :]).astype(np.float32)


def zipf_mixture(n: int, d: int, seed: int = 0, *, n_clusters: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 5.0
    p = 1.0 / np.arange(1, n_clusters + 1)
    p /= p.sum()
    who = rng.choice(n_clusters, size=n, p=p)
    return (centers[who] + rng.normal(size=(n, d))).astype(np.float32)


GENERATORS: dict[str, Callable[..., np.ndarray]] = {
    "uniform": uniform,
    "gaussian_mixture": gaussian_mixture,
    "correlated": correlated,
    "zipf_mixture": zipf_mixture,
}


def make_queries(x: np.ndarray, m: int, seed: int = 1, *, noise: float = 0.1) -> np.ndarray:
    """Paper protocol: queries are (perturbed) held-out dataset points."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(x.shape[0], size=m, replace=False)
    q = x[idx] + noise * rng.normal(size=(m, x.shape[1]))
    return q.astype(np.float32)


def exact_knn(
    x: np.ndarray, q: np.ndarray, k: int, *, metric: str = "l2", block: int = 262144
) -> tuple[np.ndarray, np.ndarray]:
    """Blocked exact k-NN (the ground-truth oracle). Returns (ids, dists)."""
    m = q.shape[0]
    best_d = np.full((m, k), np.inf, dtype=np.float64)
    best_i = np.zeros((m, k), dtype=np.int64)
    for start in range(0, x.shape[0], block):
        xb = x[start : start + block]
        if metric == "l2":
            d2 = (
                (q.astype(np.float64) ** 2).sum(1)[:, None]
                + (xb.astype(np.float64) ** 2).sum(1)[None, :]
                - 2.0 * q.astype(np.float64) @ xb.astype(np.float64).T
            )
            np.maximum(d2, 0.0, out=d2)
        elif metric == "l1":
            d2 = np.abs(q[:, None, :].astype(np.float64) - xb[None, :, :]).sum(-1)
        else:
            raise ValueError(metric)
        ids = np.argpartition(d2, min(k, d2.shape[1] - 1), axis=1)[:, :k]
        dd = np.take_along_axis(d2, ids, axis=1)
        cat_d = np.concatenate([best_d, dd], axis=1)
        cat_i = np.concatenate([best_i, ids + start], axis=1)
        sel = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(cat_d, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
    return best_i, best_d.astype(np.float32)


def make_dataset(
    kind: str, n: int, d: int, m: int = 100, k: int = 50, seed: int = 0
) -> Dataset:
    x = GENERATORS[kind](n, d, seed)
    q = make_queries(x, m, seed + 1)
    ids, dists = exact_knn(x, q, k)
    return Dataset(f"{kind}-{n}x{d}", x, q, ids, dists)


# ----------------------------- metrics ------------------------------------


def recall(result_ids: np.ndarray, gt_ids: np.ndarray) -> float:
    """Mean |R ∩ R*| / k over queries (paper §5.1)."""
    k = gt_ids.shape[1]
    hits = [
        len(set(map(int, r[:k])) & set(map(int, g))) / k
        for r, g in zip(result_ids, gt_ids)
    ]
    return float(np.mean(hits))


def mean_relative_error(result_dists: np.ndarray, gt_dists: np.ndarray) -> float:
    """MRE over *metric* distances (paper §5.1). Inputs are squared L2 —
    converted via sqrt; zero ground-truth distances are guarded."""
    r = np.sqrt(np.maximum(np.asarray(result_dists, np.float64), 0.0))
    g = np.sqrt(np.maximum(np.asarray(gt_dists, np.float64), 0.0))
    g = np.maximum(g, 1e-12)
    return float(np.mean((r - g) / g))
