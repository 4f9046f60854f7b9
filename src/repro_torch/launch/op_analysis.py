"""Cost of a program from its op trace: the port's counterpart of the JAX
package's ``launch/hlo_analysis.analyze_hlo`` and ``launch/dryrun.
collective_bytes``.

:class:`OpTally` is a dispatch mode (:class:`repro_torch.analysis.
trace_rules.OpRecorder`) that runs a program, on real or fake tensors, and
tallies as it goes, keeping no list of ops:

* FLOPs: ``torch.utils.flop_counter``'s formulas for the ATen products,
  plus, for each kernel operator, the operations ``PERF.md`` §6's bound
  column counts for it (:func:`kernel_cost`);
* bytes: each op's input and output tensors once (a view moves nothing), a
  kernel operator's as its bound counts them;
* collectives: the output bytes and the count of each ``c10d`` op by kind,
  every launch counted (eager mode runs each one, so no loop correction);
* the largest single op output, and the peak of live bytes: each storage an
  op makes counted from the op until the last tensor on it is gone.
"""

from __future__ import annotations

import math
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.trace_rules import KERNEL_NAMESPACE, OpRecorder

__all__ = ["COLLECTIVES", "kernel_cost", "OpTally"]

#: the reference's collective kinds, by the ``c10d`` op that performs each
COLLECTIVES = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "broadcast_": "broadcast",
}
#: the same for the functional collectives DTensor's redistributions run
FUNCTIONAL_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_FUNCTIONAL = ("_c10d_functional", "_c10d_functional_autograd")
_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
          "broadcast")


def _nbytes(t) -> int:
    return math.prod(t.shape) * t.dtype.itemsize


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def kernel_cost(op: str, args, outs) -> tuple[float, float]:
    """``(operations, bytes)`` of one kernel operator call, as ``PERF.md``
    §6's bound column counts them: the fp32 / int32 operations of the
    plain arithmetic, and every input read once and every output written
    once (the candidate rerank also reads its ``m * c`` rows of ``x``, and
    its ids count at the dtype the caller holds them in: the kernel reads
    them as given, with no int32 copy before it)."""
    ins = [a for a in args if isinstance(a, torch.Tensor)]
    moved = sum(_nbytes(t) for t in (*ins, *outs))
    if op in ("sc_scores_cells", "sc_scores_cells_prefilter", "sc_scores_cells_prefilter_compact"):
        ns, m, _ = args[0].shape
        return 2.0 * ns * m * args[2].shape[1], moved
    if op == "gather_rerank_block":
        (m, c), d = args[0].shape, args[1].shape[1]
        return 3.0 * m * c * d, moved + 4 * m * c * d
    if op == "sc_scores_fused":
        ns, m, s = args[0].shape
        n = args[1].shape[1]
        return ns * (m * n * (2.0 * s + 4) + (m + n) * 2.0 * s), moved
    if op == "pairwise_sqdist":
        (m, d), n = args[0].shape, args[1].shape[0]
        return m * n * (2.0 * d + 4) + (m + n) * 2.0 * d, moved
    if op == "kmeans_stats":
        (b, n, s), k = args[0].shape, args[1].shape[1]
        return 3.0 * b * n * k * s, moved
    if op == "kmeans_pair_assign_hist":
        (b, n, s), k = args[0].shape, args[1].shape[1]
        return 2.0 * b * n * k * s, moved
    if op == "kmeans_assign_batched":
        (b, n, s), k = args[0].shape, args[1].shape[1]
        return 3.0 * b * n * k * s, moved
    if op == "kmeans_assign":
        (n, s), k = args[0].shape, args[1].shape[0]
        return 3.0 * n * k * s, moved
    if op == "linear_attn":
        # the chunked form over each chunk of c rows: the inter-chunk read
        # and state update (2 dk dv a row each), the intra-chunk scores and
        # their product with v (c dk and c dv a row)
        (bh, t, dk), dv, c = args[0].shape, args[2].shape[2], args[5]
        return 2.0 * bh * t * (2 * dk * dv + min(c, t) * (dk + dv)), moved
    raise ValueError(f"no cost formula for kernel operator {op!r}")


def _aten_flops(func, args, kwargs, out) -> float:
    """``torch.utils.flop_counter``'s count of one ATen op (0 for an op it
    has no formula for)."""
    from torch.utils.flop_counter import flop_registry

    fn = flop_registry.get(func._overloadpacket)
    return 0.0 if fn is None else float(fn(*args, **kwargs, out_val=out))


def _pause_during_meta_propagation(tally: "OpTally"):
    """Wrap DTensor's meta propagation so that ``tally`` ignores the ops it
    runs; returns the function that takes the wrapper off."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        raise RuntimeError(f"this torch's DTensor has no ShardingPropagator.{name}: the "
                           "per-rank tally cannot tell its meta propagation from the run")

    def paused(self, *args, **kwargs):
        tally._paused += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            tally._paused -= 1

    setattr(ShardingPropagator, name, paused)
    return lambda: setattr(ShardingPropagator, name, orig)


class OpTally(OpRecorder):
    """Run a program and tally its cost (see the module's docstring).

    ``arguments`` are the program's inputs: their storages are live from
    the start (``argument_bytes``) and never counted as the program's own.
    Enter a ``FlopCounterMode`` before this mode to have the ATen products
    counted too (:attr:`flops` adds them when given ``flop_counter``).

    ``per_rank=True`` tallies a program over ``DTensor``s as one rank runs
    it: an op on ``DTensor``s is left to DTensor, and what it runs on this
    rank's local shares (the local op, the functional collectives of a
    redistribution) is tallied; the ops DTensor runs on global-shaped fake
    tensors to learn an output's shape (its meta propagation) are not.
    The ATen products are then counted here, on the local shapes, not by a
    ``FlopCounterMode`` (which sees the global ops).
    """

    def __init__(self, arguments=(), flop_counter=None, per_rank: bool = False):
        super().__init__()
        self.per_rank = per_rank
        self._paused = 0
        self._unpatch = None
        self.flop_counter = flop_counter
        self.n_ops = 0
        self.kernel_flops = 0.0
        self.local_flops = 0.0
        self.bytes_accessed = 0.0
        self.kernel_calls: dict[str, int] = {}
        self.collective_bytes = {k: 0 for k in _KINDS}
        self.collective_counts = {k: 0 for k in _KINDS}
        self.largest = (0, "(no op)")
        self._live: dict[int, list[int]] = {}  # storage -> [bytes, tensors alive on it]
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.argument_bytes = 0
        for t in _tensors(list(arguments)):
            key = t.untyped_storage()._cdata
            if key not in self._live:
                nb = t.untyped_storage().nbytes()
                self._live[key] = [nb, 1 << 62]  # held by the caller throughout
                self.argument_bytes += nb
        self.live_bytes = self.peak_live_bytes = self.argument_bytes

    @property
    def flops(self) -> float:
        aten = self.flop_counter.get_total_flops() if self.flop_counter is not None else 0
        return float(aten) + self.kernel_flops + self.local_flops

    def _release(self, key: int) -> None:
        rec = self._live.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self.live_bytes -= rec[0]
            del self._live[key]

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        rec = self._live.get(key)
        if rec is None:
            rec = self._live[key] = [storage.nbytes(), 0]
            self.live_bytes += rec[0]
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        rec[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._paused or not self.per_rank:
            return super().__torch_dispatch__(func, types, args, kwargs)
        if any(isinstance(a, DTensor) for a in tree_flatten([args, kwargs or {}])[0]):
            # an op on global DTensors: let DTensor run it, and tally the
            # local ops (and redistributions) it runs on this rank's shares
            return NotImplemented
        return super().__torch_dispatch__(func, types, args, kwargs)

    def __enter__(self):
        if self.per_rank:
            self._unpatch = _pause_during_meta_propagation(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._unpatch is not None:
                self._unpatch()
                self._unpatch = None

    def on_op(self, func, args, kwargs, out) -> None:
        if self._paused:
            return
        self.n_ops += 1
        outs = _tensors(out)
        name = func._opname
        if func.namespace == "c10d" or func.namespace in _FUNCTIONAL:
            table = COLLECTIVES if func.namespace == "c10d" else FUNCTIONAL_COLLECTIVES
            kind = table.get(name)
            if kind is not None:
                self.collective_bytes[kind] += sum(_nbytes(t) for t in outs)
                self.collective_counts[kind] += 1
                for t in outs:
                    self._hold(t)
            return
        if func.namespace == KERNEL_NAMESPACE:
            ops, moved = kernel_cost(name, args, outs)
            self.kernel_flops += ops
            self.bytes_accessed += moved
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        elif not func.is_view:
            self.bytes_accessed += sum(_nbytes(t) for t in (*_tensors([args, kwargs]), *outs))
            if self.per_rank:
                self.local_flops += _aten_flops(func, args, kwargs, out)
        if not func.is_view:
            for t in outs:
                if _nbytes(t) > self.largest[0]:
                    self.largest = (_nbytes(t), f"{func.namespace}::{name} -> "
                                                f"{t.dtype}{list(t.shape)}")
        for t in outs:
            self._hold(t)

    def summary(self) -> dict:
        total = sum(self.collective_bytes.values())
        return {
            "ops": self.n_ops,
            "kernel_calls": dict(sorted(self.kernel_calls.items())),
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collectives": {"total_bytes": total, "per_kind_bytes": dict(self.collective_bytes),
                            "counts": dict(self.collective_counts)},
            "largest_intermediate": {"bytes": self.largest[0], "where": self.largest[1]},
            "argument_bytes": self.argument_bytes,
            "peak_live_bytes": self.peak_live_bytes,
        }
