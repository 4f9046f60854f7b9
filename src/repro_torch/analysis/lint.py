"""The static gate's CLI: ``python -m repro_torch.analysis.lint``.

Runs both engines over everything the registry declares and reports either a
human summary or machine-readable JSON (``--format=json``).  Exit status is 0
iff no unsuppressed finding and no engine error.

Options::

    --format {human,json}   report format (default: human)
    --output PATH           also write the report to a file (CI artifact)
    --rules A,B             only run the named rules
    --entries GLOB          only check entry names / file paths matching GLOB
    --disable A,B           run but suppress the named rules (audited opt-out)
    --list                  list registered entries and rules, then exit
"""

from __future__ import annotations

import argparse
import sys
from typing import Sequence

from repro_torch.analysis import ast_rules, registry, trace_rules
from repro_torch.analysis.findings import Finding, Report

ALL_RULES: tuple[str, ...] = (
    tuple(trace_rules.TRACE_RULES) + ("tile-shape",) + ast_rules.AST_RULES
)

RULE_DOCS: dict[str, str] = {**trace_rules.RULE_DOCS, **ast_rules.AST_RULE_DOCS}


def _filter_rules(findings: list[Finding], rules: set[str] | None) -> list[Finding]:
    if rules is None:
        return findings
    return [f for f in findings if f.rule in rules]


def _disable(findings: list[Finding], disabled: set[str]) -> list[Finding]:
    out = []
    for f in findings:
        if not f.suppressed and f.rule in disabled:
            f = Finding(
                rule=f.rule,
                target=f.target,
                message=f.message,
                severity=f.severity,
                suppressed=True,
                suppress_reason="disabled on the command line",
            )
        out.append(f)
    return out


def lint_entry(entry, rules: set[str] | None = None) -> tuple[list[Finding], list[str]]:
    """Run one registry entry through its applicable trace / tile rules."""
    findings, checked = trace_rules.run_trace_rules(entry)
    if rules is not None:
        checked = [r for r in checked if r in rules]
        findings = _filter_rules(findings, rules)
    return findings, checked


def run_lint(
    rules: set[str] | None = None,
    entries_glob: str = "*",
    disabled: set[str] | None = None,
) -> Report:
    """Run both engines; never raises on a rule failure, only records it."""
    report = Report()

    want_trace = rules is None or bool(
        rules & (set(trace_rules.TRACE_RULES) | {"tile-shape"})
    )
    if want_trace:
        try:
            entries = registry.collect_entries(pattern=entries_glob)
        except Exception as exc:  # a broken hook must fail the run
            report.errors.append(f"registry collection failed: {exc!r}")
            entries = []
        for entry in entries:
            try:
                findings, checked = lint_entry(entry, rules)
            except Exception as exc:
                report.errors.append(f"entry {entry.name!r} failed to trace: {exc!r}")
                continue
            report.extend(findings)
            for rule in checked:
                report.mark_checked(rule, entry.name)

    want_ast = rules is None or bool(rules & set(ast_rules.AST_RULES))
    if want_ast:
        for target in registry.ast_targets(pattern=entries_glob):
            try:
                findings = ast_rules.lint_target(target)
            except Exception as exc:
                report.errors.append(f"AST scan of {target.name} failed: {exc!r}")
                continue
            report.extend(_filter_rules(findings, rules))
            for rule in ast_rules.AST_RULES:
                if rules is None or rule in rules:
                    report.mark_checked(rule, target.name)

    if disabled:
        report.findings = _disable(report.findings, disabled)
    return report


def _parse_args(argv: Sequence[str] | None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="The static gate: prove the serving invariants before the card runs.",
    )
    parser.add_argument("--format", choices=("human", "json"), default="human")
    parser.add_argument("--output", default=None, help="also write the report here")
    parser.add_argument("--rules", default=None, help="comma-separated rule subset")
    parser.add_argument("--entries", default="*", help="glob over entry/file names")
    parser.add_argument("--disable", default=None, help="suppress these rules")
    parser.add_argument("--list", action="store_true", help="list entries and rules")
    return parser.parse_args(argv)


def _split(value: str | None) -> set[str] | None:
    if value is None:
        return None
    return {v.strip() for v in value.split(",") if v.strip()}


def main(argv: Sequence[str] | None = None) -> int:
    args = _parse_args(argv)

    if args.list:
        print("rules:")
        for rule in ALL_RULES:
            print(f"  {rule}: {RULE_DOCS[rule]}")
        print("trace/tile entries:")
        for entry in registry.collect_entries(pattern=args.entries):
            kind = "tile" if isinstance(entry, registry.TileEntry) else "trace"
            note = f" — {entry.note}" if entry.note else ""
            print(f"  [{kind}] {entry.name}{note}")
        print("ast targets:")
        for target in registry.ast_targets(pattern=args.entries):
            print(f"  {target.name}")
        return 0

    rules = _split(args.rules)
    if rules is not None:
        unknown = rules - set(ALL_RULES)
        if unknown:
            print(f"unknown rule(s): {sorted(unknown)}", file=sys.stderr)
            return 2

    report = run_lint(
        rules=rules, entries_glob=args.entries, disabled=_split(args.disable)
    )
    text = report.to_json() if args.format == "json" else report.render(RULE_DOCS)
    print(text)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
