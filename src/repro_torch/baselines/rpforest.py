"""Random-projection forest baseline (Annoy-style trees): the counterpart
of ``repro.baselines.rpforest``.

The build follows the reference node by node, depth first, so each
internal node takes the next ``normal(size=d)`` draw of one
``np.random.default_rng(seed)``, as there; each node's projection, median
split and partition run on the device the data lies on.  The trees are
held as flat arrays (a node's children, hyperplane and offset, a leaf's
range in one id array), and a query batch descends every tree at once on
the device, then takes the union of the leaves it reached (until
``search_k`` points, tree by tree) and re-ranks it exactly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.baselines._common import (
    as_points, as_queries, first_true, ragged, rerank, short_rows_to_brute_force,
)

__all__ = ["RPForest"]


class _Nodes:
    """Trees flattened depth first: per node its children (-1 at a leaf),
    hyperplane ``w`` and offset ``b``, and a leaf's ids in one array."""

    def __init__(self, d: int):
        self.left, self.right, self.w, self.b, self.start, self.size = [], [], [], [], [], []
        self.leaf_ids: list[np.ndarray] = []
        self.n_leaf_ids = 0
        self.d = d

    def add(self) -> int:
        for col in (self.left, self.right, self.start, self.size):
            col.append(-1 if col is not self.size else 0)
        self.w.append(np.zeros(self.d, np.float32))
        self.b.append(np.float32(0))
        return len(self.left) - 1

    def leaf(self, i: int, ids: np.ndarray) -> None:
        self.start[i], self.size[i] = self.n_leaf_ids, len(ids)
        self.leaf_ids.append(np.asarray(ids, np.int64))
        self.n_leaf_ids += len(ids)

    def internal(self, i: int, w, b, left: int, right: int) -> None:
        self.w[i], self.b[i], self.left[i], self.right[i] = w, np.float32(b), left, right


class RPForest:
    def __init__(self, n_trees: int = 8, leaf_size: int = 64, seed: int = 0,
                 *, device: torch.device | str = "cuda"):
        self.n_trees = n_trees
        self.leaf_size = leaf_size
        self.seed = seed
        self.device = torch.device(device)

    def _build(self, ids: torch.Tensor, rng, nodes: _Nodes) -> int:
        i = nodes.add()
        if ids.numel() <= self.leaf_size:
            nodes.leaf(i, ids.cpu().numpy())
            return i
        w = rng.normal(size=self.x.shape[1]).astype(np.float32)
        proj = self.x[ids] @ torch.as_tensor(w, device=self.device)
        srt = torch.sort(proj).values
        h = srt.numel() // 2
        # np.median: the middle value, or the float32 mean of the two middle ones
        b = srt[h] if srt.numel() % 2 else (srt[h - 1] + srt[h]) / 2
        go_left = proj <= b
        left, right = ids[go_left], ids[~go_left]
        if left.numel() == 0 or right.numel() == 0:
            nodes.leaf(i, ids.cpu().numpy())
            return i
        b = float(b)
        nodes.internal(i, w, b, self._build(left, rng, nodes), self._build(right, rng, nodes))
        return i

    def build(self, x) -> "RPForest":
        self.x = as_points(x, self.device)
        rng = np.random.default_rng(self.seed)
        nodes = _Nodes(self.x.shape[1])
        ids = torch.arange(self.x.shape[0], device=self.device)
        roots = [self._build(ids, rng, nodes) for _ in range(self.n_trees)]
        return self._set(nodes, roots)

    def _set(self, nodes: _Nodes, roots: Sequence[int]) -> "RPForest":
        t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=self.device)
        self.left, self.right = t(nodes.left, np.int64), t(nodes.right, np.int64)
        self.w, self.b = t(np.stack(nodes.w), np.float32), t(nodes.b, np.float32)
        self.leaf_start, self.leaf_size_ = t(nodes.start, np.int64), t(nodes.size, np.int64)
        self.leaf_ids = t(np.concatenate(nodes.leaf_ids), np.int64)
        self.roots = t(roots, np.int64)
        self.n_internal = int(sum(1 for v in nodes.left if v >= 0))
        self.depth = self._depth(nodes, roots)
        return self

    @staticmethod
    def _depth(nodes: _Nodes, roots) -> int:
        depth, frontier = 0, list(roots)
        while frontier:
            frontier = [c for i in frontier if nodes.left[i] >= 0
                        for c in (nodes.left[i], nodes.right[i])]
            depth += bool(frontier)
        return depth

    @classmethod
    def from_state(cls, x, trees: Sequence, *, leaf_size: int = 64, seed: int = 0,
                   device: torch.device | str = "cuda") -> "RPForest":
        """A forest over the reference's trees: nodes whose ``ids`` is set
        are leaves, the others carry ``w`` / ``b`` / ``left`` / ``right``."""
        rp = cls(len(trees), leaf_size, seed, device=device)
        rp.x = as_points(x, rp.device)
        nodes = _Nodes(rp.x.shape[1])

        def walk(nd) -> int:
            i = nodes.add()
            if nd.ids is not None:
                nodes.leaf(i, nd.ids)
            else:
                nodes.internal(i, np.asarray(nd.w, np.float32), nd.b, walk(nd.left),
                               walk(nd.right))
            return i

        return rp._set(nodes, [walk(tree) for tree in trees])

    def memory_bytes(self) -> int:
        # the reference's accounting: int64 leaf ids, a fp32 hyperplane and 8 bytes a split
        return self.leaf_ids.numel() * 8 + self.n_internal * (self.w.shape[1] * 4 + 8)

    def query(self, q, k: int, search_k: int | None = None) -> torch.Tensor:
        """``q: (m, d)`` -> ``(m, k)`` int64 ids; a query whose leaves hold
        fewer than ``k`` points answers by brute force."""
        search_k = search_k or (self.n_trees * self.leaf_size)
        q = as_queries(q, self.x.shape[1], self.device)
        m, n = q.shape[0], self.x.shape[0]
        cur = self.roots[None, :].expand(m, -1).contiguous()  # (m, T)
        for _ in range(self.depth):
            inner = self.left[cur] >= 0
            go_left = (q[:, None, :] * self.w[cur]).sum(-1) <= self.b[cur]
            cur = torch.where(inner, torch.where(go_left, self.left[cur], self.right[cur]), cur)
        sizes = self.leaf_size_[cur]
        before = torch.cumsum(sizes, 1) - sizes
        visit = before < search_k  # tree by tree until search_k points
        hits, valid = ragged(self.leaf_start[cur], torch.where(visit, sizes, 0), self.leaf_ids)
        mask = torch.zeros((m, n + 1), dtype=torch.bool, device=self.device)
        mask.scatter_(1, torch.where(valid, hits, n), True)  # padding lands in column n
        cand, cvalid = first_true(mask[:, :n])
        ids, _ = rerank(self.x, q, cand, cvalid, k)
        return short_rows_to_brute_force(self.x, q, ids, cvalid.sum(1), k)
