"""Subspace-Collision sparse attention (the counterpart of
``repro.core.sc_attention``, an application beyond the paper).

Long-context decode scores one query against a long KV cache.  Treat the
cached keys of a head as the dataset and the query as the query point:
split ``hd`` into ``n_subspaces`` subspaces, count in how many of them a
key's negated partial inner product is at most the ``alpha * S``-th
smallest (its SC-score), keep the ``n_keep`` keys of highest score and run
exact softmax attention over those alone.  The quality metric is
*attention-mass recall*: the share of the full softmax mass the kept keys
carry.

As the reference: among equal scores (integers in ``0..n_subspaces``, so
nearly every score ties) the lower key index is kept first, the order of
``jax.lax.top_k``; here a stable descending sort gives it (``torch.topk``
gives neither that order nor the same set).  A partial product that ties
``tau`` within a few ulp may count on one package and not the other, as
in SC-Linear (``ROADMAP.md``, Tolerances).  Plain PyTorch on both devices:
the reference has no Pallas kernel here.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.collision import kth_smallest

__all__ = ["sc_select_keys", "sc_sparse_attention", "attention_mass_recall", "sc_key_scores"]


def sc_key_scores(q: torch.Tensor, keys: torch.Tensor, n_subspaces: int,
                  count: int) -> torch.Tensor:
    """``q: (H, hd), keys: (H, S, hd) -> (H, S)`` int32 SC-scores: in each
    subspace of width ``hd // n_subspaces`` (trailing dims past
    ``n_subspaces`` whole widths unused), a key collides where ``-(k . q)``
    there is at most its ``count``-th smallest.  One product a subspace over
    a strided view of the keys: no copy of the cache."""
    h, s, hd = keys.shape
    w = hd // n_subspaces
    scores = torch.zeros((h, s), dtype=torch.int32, device=keys.device)
    for i in range(n_subspaces):
        ks = keys[..., i * w:(i + 1) * w]  # (H, S, w)
        d = -torch.matmul(ks, q[:, i * w:(i + 1) * w, None])[..., 0]  # (H, S)
        tau = kth_smallest(d, count)
        scores += (d <= tau[:, None]).to(torch.int32)
    return scores


def sc_select_keys(
    q: torch.Tensor,  # (H, hd)
    keys: torch.Tensor,  # (H, S, hd)
    *,
    n_subspaces: int = 4,
    alpha: float = 0.05,
    n_keep: int = 1024,
) -> torch.Tensor:
    """Per head: ids ``(H, n_keep)`` (int64) of the highest-SC-score keys,
    the lower index first among equal scores."""
    s = keys.shape[1]
    count = max(1, int(alpha * s))
    sc = sc_key_scores(q, keys, n_subspaces, count)
    return torch.sort(sc, dim=-1, descending=True, stable=True).indices[:, :n_keep]


def _gather_rows(a: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``a: (H, S, d)``, ``ids: (H, n)`` -> ``(H, n, d)``."""
    return torch.gather(a, 1, ids[..., None].expand(-1, -1, a.shape[-1]))


def sc_sparse_attention(
    q: torch.Tensor,  # (H, hd)
    keys: torch.Tensor,  # (H, S, hd)
    values: torch.Tensor,  # (H, S, hd)
    *,
    n_subspaces: int = 4,
    alpha: float = 0.05,
    n_keep: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(output (H, hd), selected ids (H, n_keep))``: softmax attention of
    each head's query over its selected keys alone."""
    ids = sc_select_keys(q, keys, n_subspaces=n_subspaces, alpha=alpha, n_keep=n_keep)
    scale = 1.0 / math.sqrt(q.shape[-1])
    ks, vs = _gather_rows(keys, ids), _gather_rows(values, ids)
    logits = torch.matmul(ks, q[..., None])[..., 0] * scale
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w[:, None], vs)[:, 0], ids


def attention_mass_recall(q: torch.Tensor, keys: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """``(H,)``: the share of each head's full softmax mass on ``ids``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    w = torch.softmax(torch.matmul(keys, q[..., None])[..., 0] * scale, dim=-1)
    return torch.gather(w, 1, ids.long()).sum(-1)
