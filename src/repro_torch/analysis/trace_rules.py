"""Engine 1: structural rules over op traces.

The counterpart of ``repro.analysis.jaxpr_rules``.  Where the JAX package
reads the closed jaxpr XLA will compile, the port runs the entry once on
the CPU on seeded data under :class:`OpTrace`, a ``TorchDispatchMode``
that records every op the dispatcher runs: each ATen op, and each kernel
operator (``torch.ops.repro_torch.*``) as one leaf, as a ``pallas_call`` is
one equation.  The loop scope comes from the ``loop:`` spans
(:mod:`repro_torch.core.spans`) the chunk loops open, which the mode sees
as the profiler's ``_record_function_enter_new`` / ``_exit`` ops.  Eager
mode records only the branch each step took, so an entry's data must drive
every branch the rule cares about (the fused query's first chunk always
takes the overflow fallback: its threshold is -1).

Rules: no sort or scatter inside a loop span, the largest single op output
within the entry's budget, float reductions accumulating in fp32 or wider,
and each kernel operator's launches within the H100's limits.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import TileEntry, TraceEntry
from repro_torch.core.spans import LOOP_PREFIX, recording

__all__ = [
    "TensorMeta", "OpEvent", "OpRecorder", "OpTrace", "trace", "peak_intermediate_bytes",
    "TRACE_RULES", "RULE_DOCS", "run_trace_rules", "rule_no_scatter_in_scan",
    "rule_bounded_intermediate", "rule_pinned_accumulator", "rule_tile_shape",
]

KERNEL_NAMESPACE = "repro_torch"
_ENTER = torch.ops.profiler._record_function_enter_new.default
_EXIT = torch.ops.profiler._record_function_exit._RecordFunction
_PRIM_DEVICE = torch.ops.prim.device.default
_TO_COPY = torch.ops.aten._to_copy.default


def _stays(t, kwargs) -> bool:
    """Whether ``_to_copy(t, **kwargs)`` of a fake tensor asks for nothing
    that ``t`` is not already: ``Tensor.to`` returns ``t`` itself then."""
    if not isinstance(t, FakeTensor):
        return False
    dev = kwargs.get("device")
    if dev is not None:
        dev = torch.device(dev)
        if dev.type != t.fake_device.type or dev.index not in (None, t.fake_device.index):
            return False
    return (kwargs.get("dtype") in (None, t.dtype) and kwargs.get("layout") in (None, t.layout)
            and kwargs.get("memory_format") in (None, torch.preserve_format)
            and not kwargs.get("pin_memory"))


class TensorMeta(NamedTuple):
    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def _meta(x):
    return TensorMeta(tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else x


def _outputs(out) -> tuple[TensorMeta, ...]:
    items = out if isinstance(out, (tuple, list)) else (out,)
    return tuple(_meta(t) for t in items if isinstance(t, torch.Tensor))


class OpEvent(NamedTuple):
    namespace: str  # "aten", "repro_torch", ...
    name: str  # the op without namespace or overload: "sort", "sc_scores_cells"
    overload: str
    depth: int  # loop spans open around it
    spans: tuple[str, ...]
    outs: tuple[TensorMeta, ...]
    view: bool  # outputs alias an input (no new memory)
    args: tuple | None  # TensorMeta'd arguments, kept for kernel operators

    @property
    def op(self) -> str:
        return f"{self.namespace}::{self.name}.{self.overload}"


class OpRecorder(TorchDispatchMode):
    """A dispatch mode that runs every op as it is and reports it to
    :meth:`on_op` with the spans open around it.  On fake tensors it answers
    the device guard's question with ``meta``, so a program on fake
    ``cuda`` tensors runs on a host with no card."""

    def __init__(self):
        super().__init__()
        self.spans: list[str] = []
        self._recording = None

    def __enter__(self):
        self._recording = recording()
        self._recording.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._recording.__exit__(None, None, None)

    @property
    def depth(self) -> int:
        return sum(1 for s in self.spans if s.startswith(LOOP_PREFIX))

    def on_op(self, func, args, kwargs, out) -> None:  # pragma: no cover - overridden
        pass

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _TO_COPY and _stays(args[0], kwargs):
            # Tensor.to asked for a move because the guard's answer (below)
            # said meta: the tensor is already where and what it asks, and
            # Tensor.to gives it back without a copy
            return args[0]
        out = func(*args, **kwargs)
        if func is _PRIM_DEVICE:
            # only a device guard asks: a fake tensor needs none
            return torch.device("meta") if isinstance(args[0], FakeTensor) else out
        if func is _ENTER:
            self.spans.append(str(args[0]))
        elif func is _EXIT:
            if self.spans:
                self.spans.pop()
        else:
            self.on_op(func, args, kwargs, out)
        return out


class OpTrace(OpRecorder):
    """Every op of a run, in order (:class:`OpEvent`)."""

    def __init__(self):
        super().__init__()
        self.events: list[OpEvent] = []

    def on_op(self, func, args, kwargs, out) -> None:
        kernel = func.namespace == KERNEL_NAMESPACE
        self.events.append(OpEvent(
            namespace=func.namespace, name=func._opname, overload=func._overloadname,
            depth=self.depth, spans=tuple(self.spans), outs=_outputs(out), view=func.is_view,
            args=tuple(tree_map(_meta, list(args))) if kernel else None,
        ))

    def kernel_ops(self) -> list[OpEvent]:
        return [e for e in self.events if e.namespace == KERNEL_NAMESPACE]


def trace(fn: Callable, *args, **kwargs) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpTrace` and return it."""
    with OpTrace() as t:
        fn(*args, **kwargs)
    return t


def peak_intermediate_bytes(tr: OpTrace) -> tuple[int, str]:
    """The largest single op output, in bytes, and where: the op and its
    shape.  Views are skipped: they allocate nothing."""
    peak, where = 0, "(no op)"
    for e in tr.events:
        if e.view:
            continue
        for o in e.outs:
            if o.nbytes > peak:
                peak, where = o.nbytes, f"{e.op} -> {o.dtype}{list(o.shape)}"
    return peak, where


# ------------------------------- rules --------------------------------------

_SORT_OPS = frozenset({"sort", "argsort", "msort"})
_SCATTER_OPS = frozenset({
    "index_put", "index_put_", "_index_put_impl_", "index_add", "index_add_", "index_copy",
    "index_copy_", "masked_scatter", "masked_scatter_", "put", "put_", "index_reduce",
    "index_reduce_",
})


def _is_scatter(name: str) -> bool:
    return name.startswith("scatter") or name in _SCATTER_OPS


def rule_no_scatter_in_scan(entry: TraceEntry, tr: OpTrace) -> list[Finding]:
    """No sort, and no scatter past ``scatter_budget_elems``, inside a loop
    span: one in a chunk loop serialises the streaming path (the fused loop
    is score -> prune -> merge with no data-sized shuffle)."""
    findings = []
    for e in tr.events:
        if e.depth == 0:
            continue
        if e.name in _SORT_OPS:
            findings.append(Finding(
                rule="no-scatter-in-scan", target=entry.name,
                message=f"{e.op} {[list(o.shape) for o in e.outs]} inside a loop span "
                        f"(loop depth {e.depth}, {e.spans[-1]})",
            ))
        elif _is_scatter(e.name):
            elems = max((math.prod(o.shape) for o in e.outs), default=0)
            if elems > entry.scatter_budget_elems:
                findings.append(Finding(
                    rule="no-scatter-in-scan", target=entry.name,
                    message=f"{e.op} of {elems} elems inside a loop span (budget "
                            f"{entry.scatter_budget_elems}, loop depth {e.depth}, {e.spans[-1]})",
                ))
    return findings


def rule_bounded_intermediate(entry: TraceEntry, tr: OpTrace) -> list[Finding]:
    """The largest single op output fits the entry's budget (the streaming
    memory claim), itself capped by the H100's device memory."""
    from repro_torch.core.tuning import static_device_limits

    hbm = static_device_limits("h100").hbm_bytes
    budget = min(hbm if entry.budget_bytes is None else entry.budget_bytes, hbm)
    peak, where = peak_intermediate_bytes(tr)
    if peak > budget:
        return [Finding(
            rule="bounded-intermediate", target=entry.name,
            message=f"peak intermediate {peak} B ({where}) exceeds the declared budget {budget} B",
        )]
    return []


#: Reductions whose accumulator dtype matters to the exactness contract.
_REDUCE_OPS = frozenset({
    "sum", "cumsum", "mean", "mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "mv", "dot",
    "addmv", "einsum", "linear", "tensordot", "_scaled_mm",
})
_LOW_PRECISION = frozenset({
    torch.float16, torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2,
})


def rule_pinned_accumulator(entry: TraceEntry, tr: OpTrace) -> list[Finding]:
    """Float reductions (sums, cumsums, products) produce fp32 or wider: a
    bf16 accumulator breaks the rerank distances' and the K-means
    statistics' parity between the paths."""
    findings = []
    for e in tr.events:
        if e.name not in _REDUCE_OPS:
            continue
        for o in e.outs:
            if o.dtype in _LOW_PRECISION:
                findings.append(Finding(
                    rule="pinned-accumulator", target=entry.name,
                    message=f"{e.op} accumulates in {o.dtype} {list(o.shape)}; reductions must "
                            "be pinned to float32",
                ))
    return findings


def rule_tile_shape(entry: TileEntry) -> list[Finding]:
    """The autotuner's tiles keep their quanta, and every launch of each
    kernel operator the entry traces fits the card: threads a block, dynamic
    shared memory, the grid's extents."""
    from repro_torch.core.tuning import static_device_limits
    from repro_torch.kernels import _plans

    limits = static_device_limits("h100")
    c = entry.contract
    findings: list[Finding] = []

    def fail(message: str) -> None:
        findings.append(Finding(rule="tile-shape", target=entry.name, message=message))

    for cfg in entry.tile_configs:
        if c.get("block_quantum") and cfg.block_n % c["block_quantum"]:
            fail(f"TileConfig block_n={cfg.block_n} not a multiple of quantum "
                 f"{c['block_quantum']}")
        if c.get("cap_quantum") and cfg.survivor_cap % c["cap_quantum"]:
            fail(f"TileConfig survivor_cap={cfg.survivor_cap} not a multiple of quantum "
                 f"{c['cap_quantum']}")
        if cfg.survivor_cap > cfg.block_n:
            fail(f"TileConfig survivor_cap={cfg.survivor_cap} exceeds block_n={cfg.block_n}")
    if entry.make is None:
        return findings

    max_threads = int(c.get("max_threads", limits.max_threads_per_block))
    smem = int(c.get("smem_bytes", limits.smem_optin_bytes))
    grid_x = int(c.get("grid_x", 2**31 - 1))
    grid_yz = int(c.get("grid_yz", 65_535))
    ops = entry.make().kernel_ops()
    if not ops:
        fail("entry declared a tile contract but traced no kernel operator")
    for e in ops:
        for ln in _plans.launches(e.name, e.args, limits):
            where = f"{e.name}: {ln.kernel} grid {ln.grid} x {ln.threads} threads"
            if ln.threads > max_threads:
                fail(f"{where}: {ln.threads} threads exceed {max_threads} a block")
            if ln.smem_bytes > smem:
                fail(f"{where}: {ln.smem_bytes} B of dynamic shared memory exceed the "
                     f"{smem} B a block may take")
            if not 1 <= ln.grid[0] <= grid_x:
                fail(f"{where}: grid x {ln.grid[0]} outside [1, {grid_x}]")
            if not all(1 <= g <= grid_yz for g in ln.grid[1:]):
                fail(f"{where}: grid y / z {ln.grid[1:]} outside [1, {grid_yz}]")
    return findings


# ------------------------------ dispatch ------------------------------------

TraceRule = Callable[[TraceEntry, OpTrace], list[Finding]]

TRACE_RULES: dict[str, TraceRule] = {
    "no-scatter-in-scan": rule_no_scatter_in_scan,
    "bounded-intermediate": rule_bounded_intermediate,
    "pinned-accumulator": rule_pinned_accumulator,
}

RULE_DOCS: dict[str, str] = {
    "no-scatter-in-scan": "no sort or scatter op runs inside a chunk loop's span",
    "bounded-intermediate": "the largest single op output fits the declared budget",
    "pinned-accumulator": "float reductions accumulate in float32, never bf16 / f16",
    "tile-shape": (
        "the autotuner's tiles keep their quanta and every kernel launch fits the H100 "
        "(threads, dynamic shared memory, grid)"
    ),
}


def _apply_suppressions(entry, findings: list[Finding]) -> list[Finding]:
    out = []
    for f in findings:
        reason = entry.suppress.get(f.rule)
        if reason is not None:
            f = Finding(rule=f.rule, target=f.target, message=f.message, severity=f.severity,
                        suppressed=True, suppress_reason=reason)
        out.append(f)
    return out


def run_trace_rules(entry: Any) -> tuple[list[Finding], list[str]]:
    """Every applicable rule for one registry entry -> ``(findings,
    rules_checked)``.  A :class:`TileEntry` takes ``tile-shape``; a
    :class:`TraceEntry` is traced once and each declared rule reads it."""
    if isinstance(entry, TileEntry):
        return _apply_suppressions(entry, rule_tile_shape(entry)), ["tile-shape"]
    tr = entry.make()
    findings: list[Finding] = []
    checked: list[str] = []
    for rule in entry.rules:
        fn = TRACE_RULES.get(rule)
        if fn is None:
            findings.append(Finding(rule=rule, target=entry.name,
                                    message=f"unknown trace rule {rule!r} declared by the entry"))
            continue
        findings.extend(fn(entry, tr))
        checked.append(rule)
    return _apply_suppressions(entry, findings), checked
