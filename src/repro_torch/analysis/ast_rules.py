"""Engine 2: Python-AST rules over the serving layer and the sharded engine.

The counterpart of ``repro.analysis.ast_rules``.  The trace engine sees the
ops a run dispatched; these rules see the Python around them.  Three rules:

* ``host-sync``: ``.item()`` / ``.cpu()`` / ``.numpy()`` / ``.tolist()``,
  ``torch.cuda.synchronize`` and ``.synchronize()`` on any other object (a
  stream, an event) block the host on the card.  Each one in
  ``repro_torch/serve`` and ``repro_torch/distributed`` carries ``#
  host-sync: ok — <reason>`` on its line (the call's last line), a reason
  after the dash required.
* ``tensor-branch``: an ``if`` / ``while`` / ``assert`` (or a conditional
  expression) whose test reads a tensor's value (``bool(t)``, ``int(t)``,
  ``float(t)``, ``t.any()``, ``t.all()``, ``t.item()``, ``torch.any``,
  ``torch.all``, ``torch.equal``, ``torch.allclose``) is an implicit sync
  in eager mode, the port's counterpart of the reference's branch on a
  tracer.  The ``host-sync`` annotation states it intended.
* ``build-in-hot-path``: a kernel library built or loaded (``_build.load``,
  ``_build.entry``, ``_build.build_all``), ``torch.compile`` or a CUDA-graph
  capture inside a ``for`` / ``while`` body: work of warm-up done per step.

A line's ``# lint: disable=<rule>[,<rule>]`` suppresses those rules on it,
reported as suppressed.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import AstTarget

__all__ = ["AST_RULES", "AST_RULE_DOCS", "SYNC_ATTRS", "host_syncs", "lint_source", "lint_target"]

SYNC_ATTRS = ("item", "cpu", "numpy", "tolist")
_OK = re.compile(r"#\s*host-sync: ok — \S")
_DISABLE = re.compile(r"#\s*lint:\s*disable=([\w,-]+)")
_VALUE_CASTS = frozenset({"bool", "int", "float"})
_VALUE_METHODS = frozenset({"any", "all", "item"})
_VALUE_FUNCS = frozenset({"torch.any", "torch.all", "torch.equal", "torch.allclose",
                          "torch.is_nonzero"})
_BUILDS = ("_build.load", "_build.entry", "_build.build_all", "torch.compile",
           "torch.cuda.graph", "torch.cuda.CUDAGraph", "torch.cuda.make_graphed_callables")


def _dotted(node: ast.AST) -> str:
    """A ``Name`` / ``Attribute`` chain as ``a.b.c``; ``''`` otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# ------------------------------ host-sync -----------------------------------


def host_syncs(source: str) -> list[tuple[int, str, bool]]:
    """``(line, what, annotated)`` for each ``.item()`` / ``.cpu()`` /
    ``.numpy()`` / ``.tolist()`` call, each ``torch.cuda.synchronize`` and
    each ``.synchronize()`` call on any other object (a stream, an event) in
    ``source``; annotated where the line carries ``# host-sync: ok —
    <reason>``."""
    lines = source.splitlines()
    found = []
    for node in ast.walk(ast.parse(source)):
        what = None
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in SYNC_ATTRS):
            what = f".{node.func.attr}()"
        elif isinstance(node, ast.Attribute) and ast.unparse(node) == "torch.cuda.synchronize":
            what = "torch.cuda.synchronize"
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "synchronize"
              and ast.unparse(node.func) != "torch.cuda.synchronize"):
            what = ".synchronize()"
        if what is not None:
            line = node.end_lineno if isinstance(node, ast.Call) else node.lineno
            found.append((line, what, bool(_OK.search(lines[line - 1]))))
    return sorted(found)


def _check_host_sync(source: str, target: str) -> list[Finding]:
    out = []
    for line, what, ok in host_syncs(source):
        if ok:
            out.append(Finding(rule="host-sync", target=f"{target}:{line}",
                               message=f"{what} blocks the host on the card", suppressed=True,
                               suppress_reason="annotated host-sync: ok"))
        else:
            out.append(Finding(rule="host-sync", target=f"{target}:{line}",
                               message=f"unannotated host sync: {what} (add '# host-sync: ok "
                                       "— <reason>' if intended)"))
    return out


# ---------------------------- tensor-branch ---------------------------------


def _on_numpy(node: ast.AST) -> bool:
    """Whether an expression is the result of a numpy call (a host array)."""
    while isinstance(node, ast.Call):
        name = _dotted(node.func)
        if name.split(".")[0] in ("np", "numpy"):
            return True
        node = node.func.value if isinstance(node.func, ast.Attribute) else None
    return False


def _reads_value(test: ast.AST) -> str | None:
    """What in a branch's test reads a tensor's value, if anything."""
    for node in ast.walk(test):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name in _VALUE_CASTS and node.args and isinstance(
                node.args[0], (ast.Call, ast.Compare, ast.BinOp, ast.UnaryOp, ast.Subscript)):
            inner = node.args[0]
            if not (isinstance(inner, ast.Call) and _dotted(inner.func) in ("len", "round")):
                return f"{name}({ast.unparse(inner)})"
        if name in _VALUE_FUNCS:
            return f"{name}(...)"
        if (isinstance(node.func, ast.Attribute) and node.func.attr in _VALUE_METHODS
                and not node.args and not node.keywords and not _on_numpy(node.func.value)):
            return f"{ast.unparse(node.func)}()"
    return None


def _check_tensor_branch(tree: ast.AST, source: str, target: str) -> list[Finding]:
    lines = source.splitlines()
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            continue
        what = _reads_value(node.test)
        if what is None:
            continue
        line = node.test.end_lineno
        kind = type(node).__name__.lower()
        if _OK.search(lines[line - 1]):
            out.append(Finding(rule="tensor-branch", target=f"{target}:{line}",
                               message=f"{kind} on {what}", suppressed=True,
                               suppress_reason="annotated host-sync: ok"))
        else:
            out.append(Finding(rule="tensor-branch", target=f"{target}:{line}",
                               message=f"{kind} on {what}: a branch on a tensor's value "
                                       "syncs the host; keep the decision on the device or "
                                       "annotate it '# host-sync: ok — <reason>'"))
    return out


# --------------------------- build-in-hot-path ------------------------------


def _check_build_in_hot_path(tree: ast.AST, target: str) -> list[Finding]:
    out = []
    seen: set[int] = set()
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.While, ast.AsyncFor)):
            continue
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            name = _dotted(node.func)
            if any(name == b or name.endswith("." + b) for b in _BUILDS):
                seen.add(id(node))
                out.append(Finding(
                    rule="build-in-hot-path", target=f"{target}:{node.lineno}",
                    message=f"{name}(...) inside a loop body: a build, compile or graph "
                            "capture per step; hoist it into the warm-up",
                ))
    return out


# ------------------------------ dispatch ------------------------------------

AST_RULES: tuple[str, ...] = ("host-sync", "tensor-branch", "build-in-hot-path")

AST_RULE_DOCS: dict[str, str] = {
    "host-sync": (
        "every .item() / .cpu() / .numpy() / .tolist() / synchronize carries "
        "'# host-sync: ok — <reason>'"
    ),
    "tensor-branch": "no if / while / assert reads a tensor's value unannotated",
    "build-in-hot-path": "no kernel build, torch.compile or graph capture inside a loop body",
}


def lint_source(source: str, target: str) -> list[Finding]:
    """Every AST rule over one file's source text."""
    tree = ast.parse(source, filename=target)
    disabled: dict[int, set[str]] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _DISABLE.search(line)
        if m:
            disabled[lineno] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    findings = (_check_host_sync(source, target) + _check_tensor_branch(tree, source, target)
                + _check_build_in_hot_path(tree, target))
    out = []
    for f in findings:
        lineno = int(f.target.rsplit(":", 1)[1])
        if not f.suppressed and f.rule in disabled.get(lineno, ()):
            f = Finding(rule=f.rule, target=f.target, message=f.message, severity=f.severity,
                        suppressed=True, suppress_reason="line disable comment")
        out.append(f)
    return out


def lint_target(target: AstTarget) -> list[Finding]:
    return lint_source(target.path.read_text(), target.name)
