"""Pairwise squared L2: checks its arguments, then dispatches on the device
of the tensors it was given.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel (:mod:`.kernel`), and a failed build or launch raises: the
operator ``torch.ops.repro_torch.pairwise_sqdist`` dispatches by device
(:mod:`repro_torch.kernels._library`).  Nothing
is padded: the kernel masks its ragged tiles, and rows need only be
contiguous, so a subspace view ``x[:, a:b]`` of a ``(n, d)`` array is taken
as it is.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _library
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


def _cpu(q, x):
    return pairwise_sqdist_ref(q, x)


def _cuda(q, x):
    return kernel.pairwise_sqdist(q, x)


def _meta(q, x):
    return q.new_empty((q.shape[0], x.shape[0]))


_OP = _library.define("pairwise_sqdist(Tensor q, Tensor x) -> Tensor", cpu=_cpu, cuda=_cuda,
                      meta=_meta)


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
    _library.route(q.device, "pairwise_sqdist")
    return _OP(q, x)


# --------------------------------------------------------------------------
# Static-gate registry hook (see repro_torch.analysis)
# --------------------------------------------------------------------------


def lint_entries():
    from repro_torch.analysis.registry import TileEntry, TraceEntry
    from repro_torch.analysis.trace_rules import trace

    m, n, d = 256, 512, 256

    def inputs():
        g = torch.Generator().manual_seed(0)
        return torch.randn((m, d), generator=g), torch.randn((n, d), generator=g)

    return [
        TileEntry(name="kernels.pairwise_l2.kernel", contract={},
                  make=lambda: trace(pairwise_sqdist, *inputs()),
                  note="pairwise squared L2: 64 queries x 512 points a block"),
        TraceEntry(
            name="kernels.pairwise_l2.oracle", make=lambda: trace(pairwise_sqdist_ref, *inputs()),
            rules=("bounded-intermediate", "pinned-accumulator"), budget_bytes=4 * 2 * m * n,
            note="the plain version of the pairwise distances",
        ),
    ]
