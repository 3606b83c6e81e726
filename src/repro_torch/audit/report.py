"""Findings and their report (port of `repro/audit/report.py`).

A `Finding` is one rule violation pinned to one place (an entry point's
trace or a source line).  Rules return lists of findings; the CLI collects
them into a `Report` whose exit code is the audit's verdict.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str     # "R1".."R4", "AST" or "BUILD"
    entry: str    # entry-point name or module path
    message: str  # what is wrong, in the contract's terms
    where: str = ""  # the calling frames / file:line

    def format(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.rule} {self.entry}: {self.message}{loc}"


@dataclasses.dataclass
class Report:
    findings: list = dataclasses.field(default_factory=list)
    entries_checked: list = dataclasses.field(default_factory=list)
    modules_linted: list = dataclasses.field(default_factory=list)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    @property
    def ok(self) -> bool:
        return not self.findings

    def exit_code(self) -> int:
        return 0 if self.ok else 1

    def by_rule(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out

    def format(self, *, verbose: bool = False) -> str:
        lines = ["FAIL " + f.format() for f in self.findings]
        verdict = "clean" if self.ok else f"{len(self.findings)} finding(s)"
        lines.append(f"audit: {len(self.entries_checked)} entry point(s), "
                     f"{len(self.modules_linted)} module(s) linted -> {verdict}")
        return "\n".join(lines)
