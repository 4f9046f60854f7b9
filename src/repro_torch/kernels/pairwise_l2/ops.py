"""Pairwise squared L2: checks its arguments, then dispatches on the device
of the tensors it was given.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel (:mod:`.kernel`), and a failed build or launch raises.  Nothing
is padded: the kernel masks its ragged tiles, and rows need only be
contiguous, so a subspace view ``x[:, a:b]`` of a ``(n, d)`` array is taken
as it is.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_tensor, same_device
from repro_torch.kernels.pairwise_l2 import kernel
from repro_torch.kernels.pairwise_l2.ref import pairwise_sqdist_ref

__all__ = ["pairwise_sqdist", "pairwise_sqdist_ref"]

#: Most query rows and points of one launch: a block's 64 query rows and 512
#: points keep C ``int`` indices (the source's ``kMaxRows``, ``kMaxPoints``).
MAX_ROWS = 2**31 - kernel.QUERIES
MAX_POINTS = 2**31 - kernel.POINTS
#: Most work items of one launch, one block each (:func:`kernel.items`): its
#: grid's x extent.
MAX_ITEMS = 2**31 - 1


def pairwise_sqdist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``q: (m, d), x: (n, d)`` float32 with contiguous rows ``-> (m, n)``
    float32 ``max(|q|^2 + |x|^2 - 2 q.x, 0)``, summed in a fixed order; a
    NaN distance stays NaN, as in ``torch.clamp_min``."""
    m, d = check_tensor("q", q, torch.float32, 2, rows_only=True)
    n, dx = check_tensor("x", x, torch.float32, 2, rows_only=True)
    if dx != d:
        raise ValueError(f"q has {d} dims but x has {dx}")
    same_device(q, x)
    if min(m, n, d) < 1:
        raise ValueError(f"need m, n and d >= 1, got {m}/{n}/{d}")
    if m > MAX_ROWS:
        raise ValueError(f"m={m} exceeds the kernel's {MAX_ROWS} query rows")
    if n > MAX_POINTS:
        raise ValueError(f"n={n} exceeds the kernel's {MAX_POINTS} points")
    if kernel.items(m, n) > MAX_ITEMS:
        raise ValueError(f"m={m} x n={n} exceeds the kernel's {MAX_ITEMS} work items "
                         f"of {kernel.QUERIES} x {kernel.POINTS}")
    if q.device.type == "cpu":
        return pairwise_sqdist_ref(q, x)
    if q.device.type == "cuda":
        return kernel.pairwise_sqdist(q, x)
    raise ValueError(f"no pairwise_sqdist route for device {q.device}")
