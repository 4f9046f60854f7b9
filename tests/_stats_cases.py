"""Skewed inputs for the Lloyd-statistics op (row 3 of the kernel table),
numpy only: ``tests/test_torch_kmeans.py`` holds the plain version to the
JAX kernel on them, ``tests/test_torch_cuda.py`` both kernel variants to the
plain version.

``KINDS``: ``one_takes_all`` puts every point of a codebook on one centroid
(one bucket fills each tile and chunk); ``most_empty`` puts the points on 3
of the ``k`` centroids; ``ragged`` spreads them over all.  The callers pick
``n`` off every chunk, so the last chunk is ragged in each kind.
"""

import numpy as np

#: (s, k) of row 3 on the card's paths: the SuCo build's half-subspaces,
#: PQ8x8's sub-vectors, IVF1024 at d = 128
SHAPES = ((8, 50), (16, 256), (128, 1024))
KINDS = ("one_takes_all", "most_empty", "ragged")


def skewed(kind: str, b: int, n: int, k: int, s: int, seed: int, integer: bool = True):
    """``(x (b, n, s), c (b, k, s))`` float32.  ``integer``: integer values
    below 30 in magnitude, on which every fp32 arithmetic of the statistics is
    exact (ties included); else the same layout with Gaussian noise."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-4, 5, size=(b, k, s)).astype(np.float64)
    if kind == "ragged":
        x = rng.integers(-4, 5, size=(b, n, s)).astype(np.float64)
        if not integer:
            x, c = x + rng.normal(size=x.shape) * 0.3, c + rng.normal(size=c.shape) * 0.3
        return x.astype(np.float32), c.astype(np.float32)
    if kind == "one_takes_all":
        used = np.array([[(3 + 7 * i) % k] for i in range(b)])
    else:  # most_empty
        used = np.array([sorted({0, k // 2, k - 1}) for _ in range(b)])
    far = np.ones((b, k), bool)
    np.put_along_axis(far, used, False, axis=1)
    c[far] += 20.0  # the unused centroids lie far from every point
    who = np.take_along_axis(used, rng.integers(0, used.shape[1], size=(b, n)), axis=1)
    x = np.take_along_axis(c, who[..., None], axis=1)
    if integer:
        x = x + rng.integers(-1, 2, size=x.shape)
    else:
        x, c = x + rng.normal(size=x.shape) * 0.5, c + rng.normal(size=c.shape) * 0.05
    return x.astype(np.float32), c.astype(np.float32)
