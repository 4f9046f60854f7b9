"""The static gate: the serving invariants proved before the card runs.

The counterpart of the JAX package's ``repro.analysis``, in milliseconds to
seconds on the CPU, from two sources of truth:

* **Engine 1** (:mod:`repro_torch.analysis.trace_rules`) runs each
  registered entry point (the query paths, the engine's per-bucket query,
  the chunked build, the pool merges, each kernel operator) once on the CPU
  on seeded data under a ``TorchDispatchMode`` and checks the op trace: no
  sort or scatter inside a chunk loop's span, the largest intermediate
  within the declared budget, float reductions pinned to fp32, and each
  kernel operator's launches within the H100's limits.
* **Engine 2** (:mod:`repro_torch.analysis.ast_rules`) parses the Python of
  the serving layer and the sharded engine (``repro_torch/serve``,
  ``repro_torch/distributed``) for host syncs missing their ``#
  host-sync: ok — <reason>`` annotation, branches on a tensor's value and
  kernel builds inside a loop.

Entry points register through ``lint_entries()`` hooks in the core modules
and the kernel op modules (:mod:`repro_torch.analysis.registry`); the CLI is
``python -m repro_torch.analysis.lint`` (human or ``--format json`` report,
per-rule suppressions).
"""

from repro_torch.analysis.ast_rules import AST_RULES, lint_source
from repro_torch.analysis.findings import Finding, Report
from repro_torch.analysis.registry import (
    AstTarget,
    TileEntry,
    TraceEntry,
    ast_targets,
    collect_entries,
)
from repro_torch.analysis.trace_rules import (
    TRACE_RULES,
    OpTrace,
    peak_intermediate_bytes,
    run_trace_rules,
    trace,
)

# The CLI (repro_torch.analysis.lint) is not imported here: ``python -m
# repro_torch.analysis.lint`` would otherwise import it twice.

__all__ = [
    "Finding",
    "Report",
    "TraceEntry",
    "TileEntry",
    "AstTarget",
    "collect_entries",
    "ast_targets",
    "TRACE_RULES",
    "AST_RULES",
    "OpTrace",
    "trace",
    "peak_intermediate_bytes",
    "run_trace_rules",
    "lint_source",
]
