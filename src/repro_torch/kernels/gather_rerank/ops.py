"""The candidate rerank of the fused query: exact squared L2 of gathered
rows.  Checks its arguments, clips the ids, then dispatches on the device
of the tensors it was given.

Candidate lists carry sentinel ids (``INT32_MAX``) whose distances the
caller discards; they are clipped into ``[0, n-1]`` here, once, so the
kernel never reads outside ``x``.  A CPU tensor takes the plain version
(:mod:`.ref`); a CUDA tensor launches the kernel (:mod:`.kernel`), and a
failed build or launch raises.  L2 only: the L1 metric stays on plain torch
in the caller.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_tensor, same_device
from repro_torch.kernels.gather_rerank import kernel
from repro_torch.kernels.gather_rerank.ref import gather_rerank_block_ref

__all__ = ["gather_rerank_block"]


def gather_rerank_block(
    cols: torch.Tensor, x: torch.Tensor, q: torch.Tensor
) -> torch.Tensor:
    """``cols: (m, c)`` int32/int64 row ids into ``x: (n, d)`` float32,
    ``q: (m, d)`` float32 ``-> (m, c)`` float32 exact squared L2."""
    if cols.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"cols must be int32 or int64, got {cols.dtype}")
    if cols.dim() != 2:
        raise ValueError(f"cols must have 2 dims, got shape {tuple(cols.shape)}")
    n, d = check_tensor("x", x, torch.float32, 2)
    m = cols.shape[0]
    check_tensor("q", q, torch.float32, (m, d))
    same_device(cols, x, q)
    if min(n, *cols.shape) < 1:
        raise ValueError(f"need n, m and c >= 1, got {n}/{tuple(cols.shape)}")
    ids = cols.clamp(0, n - 1).to(torch.int32).contiguous()
    if x.device.type == "cpu":
        return gather_rerank_block_ref(ids, x, q)
    if x.device.type == "cuda":
        return kernel.gather_rerank_l2(ids, x, q)
    raise ValueError(f"no gather_rerank route for device {x.device}")
