"""What the baselines share: data placement, ragged candidate lists as
padded ``(m, L)`` tensors, and the exact rerank of such lists (row 2's
gather-rerank kernel on the card, its plain version on the CPU).

Every selection is a stable sort, so candidates at equal distances keep
their list order, as the reference's ``np.argsort(d, kind="stable")``
keeps them."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.gather_rerank.ops import gather_rerank_block


def as_points(x, device) -> torch.Tensor:
    """``x`` as a contiguous float32 ``(n, d)`` tensor on ``device``."""
    t = torch.as_tensor(x, dtype=torch.float32).to(device).contiguous()
    if t.dim() != 2:
        raise ValueError(f"points must be (n, d), got {tuple(t.shape)}")
    return t


def as_queries(q, d: int, device) -> torch.Tensor:
    t = as_points(q, device)
    if t.shape[1] != d:
        raise ValueError(f"queries must be (m, {d}), got {tuple(t.shape)}")
    return t


def ragged(seg_start: torch.Tensor, seg_len: torch.Tensor, pool: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's segments of ``pool``, concatenated in order, as a padded
    matrix: ``seg_start, seg_len: (m, S)`` int64 -> ``(ids (m, L), valid
    (m, L) bool)``, ``L`` the longest row (at least 1; one host sync)."""
    m, s = seg_len.shape
    tot = seg_len.sum(1)
    width = max(int(tot.max()), 1) if m else 1
    cum = seg_len.cumsum(1).contiguous()
    j = torch.arange(width, device=pool.device).expand(m, width).contiguous()
    seg = torch.searchsorted(cum, j, right=True).clamp_max(s - 1)
    before = cum.gather(1, seg) - seg_len.gather(1, seg)
    valid = j < tot[:, None]
    pos = torch.where(valid, seg_start.gather(1, seg) + j - before, 0)
    return pool[pos], valid


def first_true(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The column ids of each row's ``True`` entries, ascending, padded:
    ``mask (m, n)`` -> ``(ids (m, L), valid (m, L))``, ``L`` the most in a
    row (at least 1)."""
    count = mask.sum(1)
    width = max(int(count.max()), 1) if mask.shape[0] else 1
    ids = torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices[:, :width]
    valid = torch.arange(width, device=mask.device)[None, :] < count[:, None]
    return ids, valid


def rerank(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor, k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` nearest of each row's valid candidates, ties to the earlier
    list position -> ``(ids (m, k) int64, dists (m, k))``; a row with fewer
    than ``k`` valid candidates ends in ``+inf`` distances."""
    d = gather_rerank_block(ids, x, q)
    d = torch.where(valid, d, float("inf"))
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.nn.functional.pad(d, (0, pad), value=float("inf"))
        ids = torch.nn.functional.pad(ids, (0, pad))
    pos = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return ids.gather(1, pos).long(), d.gather(1, pos)


def brute_force(x: torch.Tensor, q: torch.Tensor, k: int, block: int = 65_536) -> torch.Tensor:
    """The exact k nearest of all ``n`` points (ties to the lower id), in
    blocks of ``block`` points merged in id order -> ``(m, k)`` int64."""
    n = x.shape[0]
    best_i = best_d = None
    for lo in range(0, n, block):
        cols = torch.arange(lo, min(lo + block, n), device=x.device).expand(q.shape[0], -1)
        d = gather_rerank_block(cols, x, q)
        if best_d is not None:
            cols = torch.cat([best_i, cols], dim=1)
            d = torch.cat([best_d, d], dim=1)
        pos = torch.sort(d, dim=1, stable=True).indices[:, :k]
        best_i, best_d = cols.gather(1, pos), d.gather(1, pos)
    return best_i.long()


def short_rows_to_brute_force(x, q, out, n_valid: torch.Tensor, k: int) -> torch.Tensor:
    """Rows with fewer than ``k`` candidates answer by brute force over all
    ``n`` points (the reference's rule for E2LSH, IMI-PQ and RP-forest)."""
    short = torch.nonzero(n_valid < k).flatten()
    if short.numel():
        out = out.clone()
        out[short] = brute_force(x, q[short].contiguous(), k)
    return out


def int64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64)
