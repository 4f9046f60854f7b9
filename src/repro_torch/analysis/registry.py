"""Entry-point registry: what the static gate checks and where it finds it.

The counterpart of ``repro.analysis.registry``.  Modules that own a public
entry point (the query paths and the chunked build in ``core/suco.py``,
SC-Linear and the pool merges in ``core/sc_linear.py``, the tile autotuner
in ``core/tuning.py``, each kernel op under ``kernels/``) export a
module-level ``lint_entries()`` hook returning :class:`TraceEntry` /
:class:`TileEntry` records.  The hook owns the declaration (which rules
apply, the budget, the tile contract), so the invariant lives next to the
code it constrains; this module only gathers them.

Hooks are imported inside :func:`collect_entries` (and hook bodies import
this module inside themselves), so ``repro_torch.core`` never depends on
``repro_torch.analysis`` at import time.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import importlib
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

__all__ = [
    "HOOK_MODULES", "TraceEntry", "TileEntry", "AstTarget", "collect_entries",
    "AST_SCAN_PACKAGES", "ast_targets",
]

#: Modules probed for a ``lint_entries()`` hook, in report order.
HOOK_MODULES: tuple[str, ...] = (
    "repro_torch.core.suco",
    "repro_torch.core.sc_linear",
    "repro_torch.core.tuning",
    "repro_torch.kernels.sc_score.ops",
    "repro_torch.kernels.gather_rerank.ops",
    "repro_torch.kernels.kmeans_assign.ops",
    "repro_torch.kernels.pairwise_l2.ops",
)


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    """An entry point checked by the trace engine.

    ``make`` runs the entry once on the CPU on seeded data at its canonical
    shapes and returns its op trace (:func:`repro_torch.analysis.
    trace_rules.trace`): every ATen op and kernel operator it dispatched,
    with its outputs and the loop spans open around it.  ``rules`` names
    the trace rules that apply; ``budget_bytes`` is the
    ``bounded-intermediate`` ceiling (bytes of the largest single op
    output); ``scatter_budget_elems`` lets ``no-scatter-in-scan`` allow
    declared small scatters in a loop.  ``suppress`` maps a rule name to
    the reason of an audited opt-out.
    """

    name: str
    make: Callable[[], Any]
    rules: tuple[str, ...]
    budget_bytes: int | None = None
    scatter_budget_elems: int = 0
    suppress: Mapping[str, str] = dataclasses.field(default_factory=dict)
    note: str = ""


@dataclasses.dataclass(frozen=True)
class TileEntry:
    """A kernel's launch contract, checked by the ``tile-shape`` rule.

    ``make`` (optional) returns the op trace of the kernel operator at the
    entry's shapes; the rule computes each launch the operator's ``CUDA``
    implementation makes there (:mod:`repro_torch.kernels._plans`) and holds
    it to the card's limits: threads a block, dynamic shared memory, the
    grid's extents.  ``contract`` overrides those limits by name
    (``max_threads``, ``smem_bytes``, ``grid_x``, ``grid_yz``) and declares
    the autotuner's quanta (``block_quantum``, ``cap_quantum``) that
    ``tile_configs`` (:class:`repro_torch.core.tuning.TileConfig` samples)
    must keep.
    """

    name: str
    contract: Mapping[str, Any]
    make: Callable[[], Any] | None = None
    tile_configs: tuple = ()
    suppress: Mapping[str, str] = dataclasses.field(default_factory=dict)
    note: str = ""


@dataclasses.dataclass(frozen=True)
class AstTarget:
    """One source file scanned by the AST engine."""

    name: str
    path: Path


Entry = Any  # TraceEntry | TileEntry


def collect_entries(modules: Sequence[str] = HOOK_MODULES, pattern: str = "*") -> list[Entry]:
    """Import each hook module and gather its declared entries.

    ``pattern`` is an fnmatch glob over entry names (the CLI's
    ``--entries``).  An import or hook failure raises: a broken hook must
    fail the gate, not shrink what it covers.
    """
    entries: list[Entry] = []
    seen: set[str] = set()
    for modname in modules:
        hook = getattr(importlib.import_module(modname), "lint_entries", None)
        if hook is None:
            continue
        for entry in hook():
            if entry.name in seen:
                raise ValueError(f"duplicate lint entry name: {entry.name!r}")
            seen.add(entry.name)
            if fnmatch.fnmatch(entry.name, pattern):
                entries.append(entry)
    return entries


#: Packages whose Python source the AST engine scans: the serving layer and
#: the sharded engine, where a stray host sync or a build in a loop breaks
#: the latency story.
AST_SCAN_PACKAGES: tuple[str, ...] = ("serve", "distributed")


def ast_targets(pattern: str = "*") -> list[AstTarget]:
    import repro_torch

    root = Path(repro_torch.__file__).resolve().parent
    targets: list[AstTarget] = []
    for pkg in AST_SCAN_PACKAGES:
        for path in sorted((root / pkg).glob("*.py")):
            name = f"repro_torch/{pkg}/{path.name}"
            if fnmatch.fnmatch(name, pattern):
                targets.append(AstTarget(name=name, path=path))
    return targets
