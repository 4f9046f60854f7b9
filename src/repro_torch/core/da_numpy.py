"""Reference IMI traversals in numpy, kept for fidelity + Figure 6.

* :func:`multi_sequence` — the original priority-queue Multi-sequence
  algorithm from the Inverted Multi-Index paper [Babenko & Lempitsky '14].
* :func:`dynamic_activation` — the paper's Algorithm 3, verbatim: a
  heap-free frontier over activated rows.

Both return the retrieved cell list in the same (distance-ascending) order,
and the same cell set as the sort-prefix form the queries use
(:func:`repro_torch.core.suco.activate_cells_sorted`).  A copy of the JAX
package's ``repro.core.da_numpy``, which cannot be imported without JAX.
"""

from __future__ import annotations

import heapq

import numpy as np

__all__ = ["multi_sequence", "dynamic_activation"]


def multi_sequence(
    dists1: np.ndarray,
    dists2: np.ndarray,
    cell_counts: np.ndarray,
    target: int,
) -> list[tuple[int, int]]:
    """Priority-queue traversal of the IMI grid.

    ``dists1/dists2``: (sqrtK,) query-to-centroid distances per half-space.
    ``cell_counts``: (sqrtK, sqrtK) points per cell (row = half-1 cluster).
    Returns cells ``(c1, c2)`` in ascending ``dists1[c1] + dists2[c2]`` order
    until the cumulative count reaches ``target``.
    """
    k1, k2 = len(dists1), len(dists2)
    idx1 = np.argsort(dists1, kind="stable")
    idx2 = np.argsort(dists2, kind="stable")
    heap: list[tuple[float, int, int]] = [(float(dists1[idx1[0]] + dists2[idx2[0]]), 0, 0)]
    seen = {(0, 0)}
    out: list[tuple[int, int]] = []
    got = 0
    while heap and got < target:
        _, i, j = heapq.heappop(heap)
        c1, c2 = int(idx1[i]), int(idx2[j])
        out.append((c1, c2))
        got += int(cell_counts[c1, c2])
        if i + 1 < k1 and (i + 1, j) not in seen:
            seen.add((i + 1, j))
            heapq.heappush(heap, (float(dists1[idx1[i + 1]] + dists2[idx2[j]]), i + 1, j))
        if j + 1 < k2 and (i, j + 1) not in seen:
            seen.add((i, j + 1))
            heapq.heappush(heap, (float(dists1[idx1[i]] + dists2[idx2[j + 1]]), i, j + 1))
    return out


def dynamic_activation(
    dists1: np.ndarray,
    dists2: np.ndarray,
    cell_counts: np.ndarray,
    target: int,
) -> list[tuple[int, int]]:
    """Paper Algorithm 3, verbatim (array-based frontier, no heap).

    ``active_idx[p]`` is how far row ``p`` (p-th closest half-1 cluster) has
    advanced along the sorted half-2 clusters; ``active_dists[p]`` caches the
    next candidate distance of that row.  Each round pops the global minimum,
    optionally activates row ``p+1`` (only when the popped row was at column
    0), and advances row ``p``.
    """
    k1 = len(dists1)
    idx1 = np.argsort(dists1, kind="stable")
    idx2 = np.argsort(dists2, kind="stable")
    active_idx = np.zeros(k1, dtype=np.int64)
    active_dists = np.full(k1, np.inf, dtype=np.float64)
    n_active = 1
    active_dists[0] = dists1[idx1[0]] + dists2[idx2[0]]
    out: list[tuple[int, int]] = []
    got = 0
    while got < target:
        pos = int(np.argmin(active_dists[:n_active]))
        col = int(active_idx[pos])
        c1, c2 = int(idx1[pos]), int(idx2[col])
        out.append((c1, c2))
        got += int(cell_counts[c1, c2])
        if got >= target:
            break
        if col == 0 and pos < k1 - 1:
            # Activate the next row at column 0.
            n_active = max(n_active, pos + 2)
            active_idx[pos + 1] = 0
            active_dists[pos + 1] = dists1[idx1[pos + 1]] + dists2[idx2[0]]
        if col < len(idx2) - 1:
            active_idx[pos] = col + 1
            active_dists[pos] = dists1[idx1[pos]] + dists2[idx2[col + 1]]
        else:
            active_dists[pos] = np.inf
    return out
