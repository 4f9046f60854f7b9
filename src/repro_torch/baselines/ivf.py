"""IVF-Flat baseline (the VQ family's simplest member), on the device its
data lies on: the counterpart of ``repro.baselines.ivf``.

K-means over the full space (the port's K-means library from the
reference's seed rows: ``np.random.default_rng(seed).choice``, so a seed
picks the same rows); a query probes the ``nprobe`` nearest cells and scans
their inverted lists exactly.  The lists are one id array grouped by cell,
ascending within a cell, with per-cell offsets.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.baselines._common import as_points, as_queries, int64, ragged, rerank
from repro_torch.core.distances import sqdist_rowwise
from repro_torch.core.kmeans import kmeans

__all__ = ["IVFFlat"]


class IVFFlat:
    def __init__(self, n_cells: int = 256, iters: int = 10, seed: int = 0,
                 *, device: torch.device | str = "cuda"):
        self.n_cells = n_cells
        self.iters = iters
        self.seed = seed
        self.device = torch.device(device)

    def build(self, x) -> "IVFFlat":
        x = as_points(x, self.device)
        rng = np.random.default_rng(self.seed)
        seeds = rng.choice(x.shape[0], self.n_cells, replace=False)
        res = kmeans(x, self.n_cells, self.iters,
                     init_centroids=x[torch.as_tensor(seeds, device=x.device)])
        return self._set(x, res.centroids, res.assignments.long())

    def _set(self, x: torch.Tensor, centroids: torch.Tensor, assign: torch.Tensor) -> "IVFFlat":
        self.x = x
        self.centroids = centroids.contiguous()
        self.list_ids = torch.sort(assign, stable=True).indices  # by cell, ascending id
        self.list_sizes = torch.bincount(assign, minlength=self.n_cells)
        self.list_offsets = torch.cumsum(self.list_sizes, 0) - self.list_sizes
        return self

    @classmethod
    def from_state(cls, x, centroids, lists: Sequence, *, iters: int = 10, seed: int = 0,
                   device: torch.device | str = "cuda") -> "IVFFlat":
        """An index over the reference's state: its ``centroids`` and its
        inverted ``lists`` (one id array per cell)."""
        ivf = cls(len(lists), iters, seed, device=device)
        x = as_points(x, ivf.device)
        assign = np.empty(x.shape[0], np.int64)
        for j, ids in enumerate(lists):
            assign[int64(ids)] = j
        return ivf._set(x, as_points(centroids, ivf.device),
                        torch.as_tensor(assign, device=ivf.device))

    @property
    def lists(self) -> list[np.ndarray]:
        """The inverted lists as the reference holds them (host arrays)."""
        ids, sizes = self.list_ids.cpu().numpy(), self.list_sizes.cpu().numpy()
        return np.split(ids, np.cumsum(sizes)[:-1])

    def memory_bytes(self) -> int:
        # the reference's accounting: fp32 centroids, int64 list ids
        return self.centroids.numel() * 4 + self.list_ids.numel() * 8

    def query(self, q, k: int, nprobe: int = 8) -> torch.Tensor:
        """``q: (m, d)`` -> ``(m, k)`` int64 ids.  A query with no candidate
        reranks the first ``min(k, n)`` ids; one with fewer than ``k`` pads
        with its nearest."""
        q = as_queries(q, self.x.shape[1], self.device)
        m, n = q.shape[0], self.x.shape[0]
        nprobe = min(nprobe, self.n_cells)
        if nprobe:
            dc = sqdist_rowwise(q, self.centroids)  # (m, n_cells)
            cells = torch.sort(dc, dim=1, stable=True).indices[:, :nprobe]
            cand, valid = ragged(self.list_offsets[cells], self.list_sizes[cells], self.list_ids)
        else:
            cand = torch.zeros((m, 1), dtype=torch.long, device=self.device)
            valid = torch.zeros((m, 1), dtype=torch.bool, device=self.device)
        n_valid = valid.sum(1)
        empty = n_valid == 0
        if bool(empty.any()):  # no candidate: the first min(k, n) ids
            first = torch.arange(min(k, n), device=self.device)
            width = max(cand.shape[1], first.numel())
            cand = torch.nn.functional.pad(cand, (0, width - cand.shape[1]))
            valid = torch.nn.functional.pad(valid, (0, width - valid.shape[1]))
            cand[empty, : first.numel()] = first
            valid[empty, : first.numel()] = True
            n_valid = valid.sum(1)
        ids, _ = rerank(self.x, q, cand, valid, k)
        # fewer than k: pad with the nearest
        return torch.where(torch.arange(k, device=self.device) < n_valid[:, None], ids, ids[:, :1])
