"""Nested dicts of tensors as trees: the leaves in the JAX package's
order (keys sorted at every level, as ``jax.tree`` flattens a dict), each
with its ``/``-joined path, and a map over trees of the same structure."""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["items", "leaves", "tree_map"]


def items(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs of ``tree`` in sorted-key order; a leaf is
    anything that is not a dict (a tensor, a 0-dim step counter)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out += items(tree[key], f"{prefix}/{key}" if prefix else str(key))
    return out


def leaves(tree: Any) -> list[torch.Tensor]:
    return [leaf for _, leaf in items(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each of
    ``rest`` (the same keys), in :func:`items`' order, as a tree of
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)
