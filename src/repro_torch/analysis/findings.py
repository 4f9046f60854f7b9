"""Finding / Report datatypes shared by both engines of the static gate and
its CLI: a copy of ``repro.analysis.findings`` (same fields, same JSON)."""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (or suppressed would-be violation) at one site.

    ``target`` is the registered entry-point name for trace rules and a
    ``path:line`` location for AST rules.  ``suppressed`` findings are kept in
    the report (so suppressions stay auditable) but do not fail the lint.
    """

    rule: str
    target: str
    message: str
    severity: str = "error"
    suppressed: bool = False
    suppress_reason: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = f"[{self.rule}]"
        if self.suppressed:
            why = f" ({self.suppress_reason})" if self.suppress_reason else ""
            return f"  suppressed {tag} {self.target}: {self.message}{why}"
        return f"  {self.severity} {tag} {self.target}: {self.message}"


@dataclasses.dataclass
class Report:
    """Aggregated lint run: every finding plus what was actually checked."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    checked: dict[str, list[str]] = dataclasses.field(default_factory=dict)
    errors: list[str] = dataclasses.field(default_factory=list)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def mark_checked(self, rule: str, target: str) -> None:
        self.checked.setdefault(rule, []).append(target)

    @property
    def fatal(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def ok(self) -> bool:
        return not self.fatal and not self.errors

    def to_json(self) -> str:
        payload = {
            "ok": self.ok,
            "n_findings": len(self.fatal),
            "n_suppressed": len(self.findings) - len(self.fatal),
            "findings": [f.to_dict() for f in self.findings],
            "checked": {rule: sorted(t) for rule, t in sorted(self.checked.items())},
            "errors": self.errors,
        }
        return json.dumps(payload, indent=2, sort_keys=False)

    def render(self, rule_docs: Mapping[str, str] | None = None) -> str:
        lines: list[str] = []
        by_rule: dict[str, list[Finding]] = {}
        for f in self.findings:
            by_rule.setdefault(f.rule, []).append(f)
        for rule in sorted(set(self.checked) | set(by_rule)):
            targets = self.checked.get(rule, [])
            hits = by_rule.get(rule, [])
            fatal = [f for f in hits if not f.suppressed]
            status = "FAIL" if fatal else "ok"
            lines.append(f"{status:>4}  {rule}  ({len(targets)} targets checked)")
            if rule_docs and rule in rule_docs:
                lines.append(f"      {rule_docs[rule]}")
            for f in hits:
                lines.append(f.render())
        for err in self.errors:
            lines.append(f"ERROR {err}")
        verdict = "clean" if self.ok else f"{len(self.fatal)} finding(s)"
        lines.append(f"lint: {verdict}")
        return "\n".join(lines)


def merge_reports(reports: Sequence[Report]) -> Report:
    out = Report()
    for r in reports:
        out.findings.extend(r.findings)
        out.errors.extend(r.errors)
        for rule, targets in r.checked.items():
            for t in targets:
                out.mark_checked(rule, t)
    return out
