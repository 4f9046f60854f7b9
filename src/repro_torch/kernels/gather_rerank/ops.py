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

from repro_torch.kernels import _library
from repro_torch.kernels._checks import check_tensor, same_device
from repro_torch.kernels.gather_rerank import kernel
from repro_torch.kernels.gather_rerank.ref import gather_rerank_block_ref

__all__ = ["gather_rerank_block"]


def _cpu(ids, x, q):
    return gather_rerank_block_ref(ids, x, q)


def _cuda(ids, x, q):
    return kernel.gather_rerank_l2(ids, x, q)


def _meta(ids, x, q):
    return ids.new_empty(ids.shape, dtype=torch.float32)


_OP = _library.define(
    "gather_rerank_block(Tensor ids, Tensor x, Tensor q) -> Tensor", cpu=_cpu, cuda=_cuda,
    meta=_meta,
)


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
    _library.route(x.device, "gather_rerank")
    return _OP(cols.clamp(0, n - 1).to(torch.int32).contiguous(), x, q)


# --------------------------------------------------------------------------
# Static-gate registry hook (see repro_torch.analysis)
# --------------------------------------------------------------------------


def lint_entries():
    from repro_torch.analysis.registry import TileEntry, TraceEntry
    from repro_torch.analysis.trace_rules import trace

    n, d, mq, mc = 4_096, 128, 8, 64

    def inputs():
        g = torch.Generator().manual_seed(0)
        cols = torch.randint(0, n, (mq, mc), generator=g, dtype=torch.int32)
        return cols, torch.randn((n, d), generator=g), torch.randn((mq, d), generator=g)

    return [
        TileEntry(name="kernels.gather_rerank.kernel", contract={},
                  make=lambda: trace(gather_rerank_block, *inputs()),
                  note="candidate gather + exact squared L2, a warp a candidate"),
        TraceEntry(
            name="kernels.gather_rerank.oracle",
            make=lambda: trace(gather_rerank_block_ref, *inputs()),
            rules=("bounded-intermediate", "pinned-accumulator"),
            budget_bytes=4 * 2 * mq * mc * d,
            note="the plain version of the candidate rerank (the CPU path)",
        ),
    ]
