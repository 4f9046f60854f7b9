"""E2LSH-style collision-counting baseline (the LSH family), on the device
its data lies on: the counterpart of ``repro.baselines.lsh``.

L tables x K p-stable projections; a point is a candidate when it collides
with the query in at least ``threshold`` tables (C2LSH / QALSH-style
counting), then the candidates are re-ranked exactly.  The projections,
offsets and hash multipliers are the reference's draws from
``np.random.default_rng(seed)`` in its order.  Where the reference keeps a
dict of id arrays per table, a table here is its ids sorted by hash
(ascending id within a bucket) beside the sorted hashes, and a query finds
its bucket by ``searchsorted``: the same candidate sets.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.baselines._common import (
    as_points, as_queries, first_true, ragged, rerank, short_rows_to_brute_force,
)

__all__ = ["E2LSH"]


class E2LSH:
    def __init__(self, n_tables: int = 8, n_bits: int = 12, w: float = 4.0, seed: int = 0,
                 *, device: torch.device | str = "cuda"):
        self.L = n_tables
        self.K = n_bits
        self.w = w
        self.seed = seed
        self.device = torch.device(device)

    def _codes(self, x: torch.Tensor) -> torch.Tensor:
        """``(n, d)`` -> ``(L, n)`` int64 bucket hashes: ``floor((a.x + b) /
        w)`` per projection, dotted with the multipliers."""
        proj = torch.einsum("lkd,nd->lnk", self.a, x) + self.b[:, None, :]
        codes = torch.floor(proj / np.float32(self.w)).long()
        return (codes * self.mult).sum(-1)

    def build(self, x) -> "E2LSH":
        x = as_points(x, self.device)
        rng = np.random.default_rng(self.seed)
        d = x.shape[1]
        a = rng.normal(size=(self.L, self.K, d)).astype(np.float32)
        b = (rng.random((self.L, self.K)) * self.w).astype(np.float32)
        mult = rng.integers(1, 2**31, size=self.K)
        self._set_planes(a, b, mult)
        h = self._codes(x)
        order = torch.sort(h, dim=1, stable=True)
        return self._set_tables(x, order.values, order.indices)

    def _set_planes(self, a, b, mult) -> None:
        self.a = torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self.b = torch.as_tensor(np.asarray(b, np.float32), device=self.device)
        self.mult = torch.as_tensor(np.asarray(mult, np.int64), device=self.device)

    def _set_tables(self, x, hashes: torch.Tensor, ids: torch.Tensor) -> "E2LSH":
        self.x = x
        self.hashes = hashes.contiguous()  # (L, n) ascending
        self.ids = ids.contiguous()  # (L, n) int64, ascending within a bucket
        new = torch.ones_like(hashes, dtype=torch.bool)
        new[:, 1:] = hashes[:, 1:] != hashes[:, :-1]
        self.n_buckets = new.sum(1)  # (L,)
        return self

    @classmethod
    def from_state(cls, x, a, b, mult, tables: Sequence[Mapping[int, np.ndarray]], *,
                   w: float = 4.0, seed: int = 0,
                   device: torch.device | str = "cuda") -> "E2LSH":
        """An index over the reference's state: its planes ``a``, offsets
        ``b``, multipliers ``mult`` and ``tables`` (per table a dict of
        bucket hash -> ascending id array)."""
        lsh = cls(len(tables), np.shape(a)[1], w, seed, device=device)
        lsh._set_planes(a, b, mult)
        hashes, ids = [], []
        for tab in tables:
            keys = sorted(tab)
            hashes.append(np.concatenate([np.full(len(tab[h]), h, np.int64) for h in keys]))
            ids.append(np.concatenate([np.asarray(tab[h], np.int64) for h in keys]))
        t = lambda a_: torch.as_tensor(np.stack(a_), device=lsh.device)
        return lsh._set_tables(as_points(x, lsh.device), t(hashes), t(ids))

    def memory_bytes(self) -> int:
        # the reference's accounting: the planes, an int64 per id and 8 bytes a bucket
        return (self.a.numel() * 4 + self.b.numel() * 4 + self.ids.numel() * 8
                + 8 * int(self.n_buckets.sum()))

    def query(self, q, k: int, threshold: int = 1) -> torch.Tensor:
        """``q: (m, d)`` -> ``(m, k)`` int64 ids; a query colliding with
        fewer than ``k`` points answers by brute force."""
        q = as_queries(q, self.x.shape[1], self.device)
        m, n = q.shape[0], self.x.shape[0]
        hq = self._codes(q)  # (L, m)
        lo = torch.searchsorted(self.hashes, hq.contiguous(), right=False)
        hi = torch.searchsorted(self.hashes, hq.contiguous(), right=True)
        start = lo + (torch.arange(self.L, device=self.device) * n)[:, None]
        hits, valid = ragged(start.T, (hi - lo).T, self.ids.reshape(-1))
        counts = torch.zeros((m, n), dtype=torch.int32, device=self.device)
        counts.scatter_add_(1, torch.where(valid, hits, 0), valid.to(torch.int32))
        cand, valid = first_true(counts >= threshold)
        ids, _ = rerank(self.x, q, cand, valid, k)
        return short_rows_to_brute_force(self.x, q, ids, valid.sum(1), k)
