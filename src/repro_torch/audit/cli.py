"""The auditor's command line.

    python -m repro_torch.audit               # the registry and the lint
    python -m repro_torch.audit --self-test   # the corpus must be caught
    python -m repro_torch.audit --list

The default mode runs every registered entry point (the distributed ones
in two spawned gloo ranks), applies its rules, lints the package's source
and checks the kernels' build flags; it exits 1 on any finding.
`--self-test` holds the auditor's own teeth: every seeded violation of
`bad_examples.py` is found under its rule, and every corrected twin audits
clean.  `--local` skips the spawned entries.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.audit import astlint, bad_examples, rules, tracer
from repro_torch.audit.report import Report


def run_default(local: bool = False, verbose: bool = False) -> Report:
    report = Report()
    specs = tracer.registry(local_only=local)
    findings, names = tracer.audit_entries(specs)
    report.extend(findings)
    report.entries_checked.extend(names)
    found, modules = astlint.lint_all()
    report.extend(found)
    report.modules_linted.extend(modules)
    report.extend(rules.check_build())
    if verbose:
        for name in names:
            print(f"  {name}")
    return report


def self_test(verbose: bool = False) -> list:
    """The failures of the self-test ([] when every bad example is caught
    under its rule and every twin is clean)."""
    failures = []
    for spec in bad_examples.bad_examples():
        want = bad_examples.expected_rule(spec.name)
        got = {f.rule for f in tracer.audit_entry(spec)}
        if want not in got:
            failures.append(f"{spec.name}: seeded {want} violation not caught "
                            f"(got {sorted(got)})")
        elif verbose:
            print(f"  {spec.name}: caught by {want}")
    for spec in bad_examples.clean_controls():
        found = tracer.audit_entry(spec)
        if found:
            failures.append(f"{spec.name}: clean twin flagged: "
                            + "; ".join(f.format() for f in found))
    for name, want, bad, good in bad_examples.source_checks():
        if want not in {f.rule for f in bad}:
            failures.append(f"{name}: seeded {want} violation not caught")
        elif verbose:
            print(f"  {name}: caught by {want}")
        if good:
            failures.append(f"{name}: clean twin flagged: " + "; ".join(f.format() for f in good))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.audit",
                                 description="the port's contract auditor")
    ap.add_argument("--self-test", action="store_true",
                    help="the seeded violations must be caught, their twins clean")
    ap.add_argument("--list", action="store_true", help="list the registry and exit")
    ap.add_argument("--local", action="store_true", help="skip the spawned entry points")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        for spec in tracer.registry():
            print(f"{spec.name:70s} rules: {', '.join(sorted(spec.rules))}")
        return 0
    if args.self_test:
        failures = self_test(args.verbose)
        for line in failures:
            print("SELF-TEST FAIL " + line)
        n = (len(bad_examples.bad_examples()) + len(bad_examples.clean_controls())
             + 2 * len(bad_examples.source_checks()))
        print(f"audit self-test: {n} case(s) -> "
              f"{'ok' if not failures else f'{len(failures)} failure(s)'}")
        return 1 if failures else 0
    report = run_default(args.local, args.verbose)
    print(report.format(verbose=args.verbose))
    return report.exit_code()


if __name__ == "__main__":
    sys.exit(main())
