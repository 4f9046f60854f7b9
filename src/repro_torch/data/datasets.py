"""Synthetic ANN data, exact ground truth and recall, in numpy.

A copy of the generators and metrics of ``repro.data.datasets`` that the
port needs (the JAX package's ``repro.data`` cannot be imported without
JAX).  Deterministic in ``seed``; float32 data.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gaussian_mixture", "make_queries", "exact_knn", "recall"]


def gaussian_mixture(
    n: int, d: int, seed: int = 0, *, n_clusters: int = 256, spread: float = 5.0
) -> np.ndarray:
    """Clustered data, the regime of SIFT/Deep (low LID)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * spread
    who = rng.integers(0, n_clusters, n)
    return (centers[who] + rng.normal(size=(n, d))).astype(np.float32)


def make_queries(x: np.ndarray, m: int, seed: int = 1, *, noise: float = 0.1) -> np.ndarray:
    """Paper protocol: queries are (perturbed) held-out dataset points."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(x.shape[0], size=m, replace=False)
    q = x[idx] + noise * rng.normal(size=(m, x.shape[1]))
    return q.astype(np.float32)


def exact_knn(
    x: np.ndarray, q: np.ndarray, k: int, *, block: int = 262144
) -> tuple[np.ndarray, np.ndarray]:
    """Blocked exact squared-L2 k-NN in float64 (the ground truth)."""
    m = q.shape[0]
    best_d = np.full((m, k), np.inf, dtype=np.float64)
    best_i = np.zeros((m, k), dtype=np.int64)
    qd = q.astype(np.float64)
    for start in range(0, x.shape[0], block):
        xb = x[start : start + block].astype(np.float64)
        d2 = (qd**2).sum(1)[:, None] + (xb**2).sum(1)[None, :] - 2.0 * qd @ xb.T
        np.maximum(d2, 0.0, out=d2)
        ids = np.argpartition(d2, min(k, d2.shape[1] - 1), axis=1)[:, :k]
        dd = np.take_along_axis(d2, ids, axis=1)
        cat_d = np.concatenate([best_d, dd], axis=1)
        cat_i = np.concatenate([best_i, ids + start], axis=1)
        sel = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(cat_d, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
    return best_i, best_d.astype(np.float32)


def recall(result_ids: np.ndarray, gt_ids: np.ndarray) -> float:
    """Mean |R ∩ R*| / k over queries (paper §5.1)."""
    k = gt_ids.shape[1]
    hits = [
        len(set(map(int, r[:k])) & set(map(int, g))) / k
        for r, g in zip(result_ids, gt_ids)
    ]
    return float(np.mean(hits))
