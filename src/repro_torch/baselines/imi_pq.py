"""IMI + Multi-sequence baseline (OPQ-lite: one global inverted
multi-index over two half-spaces, M = 2): the counterpart of
``repro.baselines.imi_pq``.

The index SuCo borrows, used the original way: one IMI over the full
space, fine cells, the Multi-sequence traversal, candidates re-ranked
exactly.  Both codebooks are trained on the device (the port's K-means
library from the reference's seed rows, drawn from one
``np.random.default_rng(seed)`` in its order); the traversal is
:func:`repro_torch.core.da_numpy.multi_sequence` on the host, over the
query-to-centroid distances computed on the device; the candidates are
gathered and re-ranked on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.baselines._common import (
    as_points, as_queries, rerank, ragged, short_rows_to_brute_force,
)
from repro_torch.core.da_numpy import multi_sequence
from repro_torch.core.distances import sqdist_rowwise
from repro_torch.core.kmeans import kmeans

__all__ = ["IMIPQ"]


class IMIPQ:
    def __init__(self, sqrt_k: int = 128, iters: int = 10, seed: int = 0,
                 *, device: torch.device | str = "cuda"):
        self.sqrt_k = sqrt_k
        self.iters = iters
        self.seed = seed
        self.device = torch.device(device)

    def _kmeans(self, x: torch.Tensor, rng) -> tuple[torch.Tensor, torch.Tensor]:
        seeds = torch.as_tensor(rng.choice(x.shape[0], self.sqrt_k, replace=False),
                                device=x.device)
        res = kmeans(x.contiguous(), self.sqrt_k, self.iters, init_centroids=x[seeds])
        return res.centroids, res.assignments.long()

    def build(self, x) -> "IMIPQ":
        x = as_points(x, self.device)
        rng = np.random.default_rng(self.seed)
        h = x.shape[1] // 2
        c1, a1 = self._kmeans(x[:, :h], rng)
        c2, a2 = self._kmeans(x[:, h:], rng)
        cell = a1 * self.sqrt_k + a2
        counts = torch.bincount(cell, minlength=self.sqrt_k**2)
        return self._set(x, c1, c2, torch.sort(cell, stable=True).indices, counts)

    def _set(self, x, c1, c2, sorted_ids, counts) -> "IMIPQ":
        self.x = x
        self.h = x.shape[1] // 2
        self.c1, self.c2 = c1.contiguous(), c2.contiguous()
        self.sorted_ids = sorted_ids.long()
        flat = counts.reshape(-1).long()
        self.offsets = torch.zeros(flat.numel() + 1, dtype=torch.long, device=x.device)
        self.offsets[1:] = torch.cumsum(flat, 0)
        self.counts = flat.reshape(self.sqrt_k, self.sqrt_k)
        self._counts_host = self.counts.cpu().numpy()  # the traversal's copy
        return self

    @classmethod
    def from_state(cls, x, c1, c2, counts, sorted_ids, *, iters: int = 10, seed: int = 0,
                   device: torch.device | str = "cuda") -> "IMIPQ":
        """An index over the reference's state: its codebooks ``c1`` /
        ``c2``, its ``(sqrtK, sqrtK)`` cell ``counts`` and ``sorted_ids``
        (the ids in cell order; the offsets follow from the counts)."""
        imi = cls(np.shape(c1)[0], iters, seed, device=device)
        t = lambda a: torch.as_tensor(np.asarray(a), device=imi.device)
        return imi._set(as_points(x, imi.device), as_points(c1, imi.device),
                        as_points(c2, imi.device), t(sorted_ids), t(counts))

    def memory_bytes(self) -> int:
        # the reference's accounting: fp32 codebooks, int64 counts, ids and offsets
        return (self.c1.numel() * 4 + self.c2.numel() * 4 + self.counts.numel() * 8
                + self.sorted_ids.numel() * 8 + self.offsets.numel() * 8)

    def query(self, q, k: int, n_candidates: int = 1000) -> torch.Tensor:
        """``q: (m, d)`` -> ``(m, k)`` int64 ids; a query whose traversed
        cells hold fewer than ``k`` points answers by brute force."""
        q = as_queries(q, self.x.shape[1], self.device)
        m = q.shape[0]
        d1 = sqdist_rowwise(q[:, : self.h], self.c1).cpu().numpy()
        d2 = sqdist_rowwise(q[:, self.h:], self.c2).cpu().numpy()
        cells = [[c1 * self.sqrt_k + c2 for c1, c2 in
                  multi_sequence(d1[i], d2[i], self._counts_host, n_candidates)]
                 for i in range(m)]
        width = max(len(c) for c in cells)
        pad = np.zeros((m, width), np.int64)
        for i, c in enumerate(cells):
            pad[i, : len(c)] = c
        used = torch.as_tensor(np.arange(width)[None, :] < np.array([len(c) for c in cells])[:, None],
                               device=self.device)
        cell = torch.as_tensor(pad, device=self.device)
        lens = torch.where(used, self.counts.reshape(-1)[cell], 0)
        cand, valid = ragged(self.offsets[cell], lens, self.sorted_ids)
        ids, _ = rerank(self.x, q, cand, valid, k)
        return short_rows_to_brute_force(self.x, q, ids, valid.sum(1), k)
