"""HNSW-lite baseline (the graph family's state of the art): the
counterpart of ``repro.baselines.hnsw``.

A single-layer NSW with HNSW's entry hierarchy collapsed to greedy
restarts: expensive neighbour identification at build, a converging greedy
walk at query.  The walk visits one node at a time, each step deciding
the next, so on the card it would be a launch per edge: this class keeps
its graph and its walk on the host, over a host copy of the data that
:meth:`build` makes with an explicit ``.cpu()``, in numpy as the
reference does.  It is the one baseline without a device path.
"""

from __future__ import annotations

import heapq
from typing import Sequence

import numpy as np
import torch

__all__ = ["HNSWLite"]


def _host(a) -> np.ndarray:
    """A float32 host copy of points given as a tensor (any device) or array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float32)


class HNSWLite:
    def __init__(self, m: int = 16, ef_construction: int = 64, seed: int = 0):
        self.m = m
        self.efc = ef_construction
        self.seed = seed

    def _search(self, q: np.ndarray, ef: int) -> list[tuple[float, int]]:
        """Beam search over the current graph; returns (dist, id) ascending."""
        x = self.x
        start = self.entry
        d0 = float(((x[start] - q) ** 2).sum())
        visited = {start}
        cand = [(d0, start)]  # min-heap of the frontier
        best: list[tuple[float, int]] = [(-d0, start)]  # max-heap of results
        while cand:
            d, u = heapq.heappop(cand)
            if d > -best[0][0] and len(best) >= ef:
                break
            for v in self.links[u]:
                if v in visited:
                    continue
                visited.add(v)
                dv = float(((x[v] - q) ** 2).sum())
                if len(best) < ef or dv < -best[0][0]:
                    heapq.heappush(cand, (dv, v))
                    heapq.heappush(best, (-dv, v))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted((-nd, i) for nd, i in best)

    def build(self, x) -> "HNSWLite":
        x = _host(x)
        self.x = x
        self.links: list[list[int]] = [[] for _ in range(x.shape[0])]
        self.entry = 0
        for i in range(1, x.shape[0]):
            nbrs = [v for _, v in self._search(x[i], self.efc)[: self.m]]
            self.links[i] = nbrs
            for v in nbrs:
                self.links[v].append(i)
                if len(self.links[v]) > 2 * self.m:
                    # prune to the closest 2M (simple heuristic)
                    dd = ((x[self.links[v]] - x[v]) ** 2).sum(1)
                    keep = np.argsort(dd, kind="stable")[: 2 * self.m]
                    self.links[v] = [self.links[v][j] for j in keep]
        return self

    @classmethod
    def from_state(cls, x, links: Sequence[Sequence[int]], entry: int = 0, *, m: int = 16,
                   ef_construction: int = 64, seed: int = 0) -> "HNSWLite":
        """A graph over the reference's state: its adjacency ``links`` and
        ``entry`` node."""
        g = cls(m, ef_construction, seed)
        g.x = _host(x)
        g.links = [[int(v) for v in lk] for lk in links]
        g.entry = int(entry)
        return g

    def memory_bytes(self) -> int:
        return sum(8 * len(lk) + 56 for lk in self.links)

    def query(self, q, k: int, ef_search: int = 64) -> torch.Tensor:
        """``q: (m, d)`` -> ``(m, k)`` int64 ids on the CPU; a short answer
        repeats its last id."""
        q = _host(q)
        out = np.zeros((q.shape[0], k), dtype=np.int64)
        for i, qi in enumerate(q):
            ids = [v for _, v in self._search(qi, max(ef_search, k))[:k]]
            while len(ids) < k:
                ids.append(ids[-1] if ids else 0)
            out[i] = ids
        return torch.from_numpy(out)
