"""Plain PyTorch version of the pairwise squared L2 kernel.

The counterpart of ``repro.kernels.pairwise_l2.ref``: the clamped identity
``max(|q|^2 + |x|^2 - 2 q.x, 0)`` in fp32.  Here each norm and each cross
term is summed one dim at a time, in index order, as separate elementwise
ops, and then combined as ``(qn + xn) - 2 * cross``: exactly the arithmetic
of the CUDA kernel (``csrc/pairwise_l2.cu``, no FMA contraction), so the two
agree bit for bit, on the card and on the CPU.  The reference sums the
cross term with a matmul instead, so the two differ by a few ulp of
``|q|^2 + |x|^2``.  It is what a CPU tensor runs and what the kernel is held
against on the card.
"""

from __future__ import annotations

import torch


def _sq_norms(a: torch.Tensor) -> torch.Tensor:
    """``(r, s) -> (r,)`` sums of squares, one dim at a time."""
    acc = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for c in range(a.shape[1]):
        acc = acc + a[:, c] * a[:, c]
    return acc


def pairwise_sqdist_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``q: (m, s), x: (n, s)`` float32 ``-> (m, n)`` float32 squared L2."""
    cross = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float32, device=q.device)
    for c in range(q.shape[1]):
        cross = cross + q[:, c, None] * x[None, :, c]
    d2 = (_sq_norms(q)[:, None] + _sq_norms(x)[None, :]) - 2.0 * cross
    return d2.clamp_min(0.0)
