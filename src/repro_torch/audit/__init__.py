"""The port's contract auditor (counterpart of `repro/audit/`).

The bit-for-bit contract (distributed, batched, padded and served runs equal
the single-device run) is held at run time by the tests; the auditor holds
its known static failure shapes: it runs each registered entry point on
the CPU under a dispatch mode (`tracer`), applies rules R1-R4 to what ran
(`rules`), lints the source for host syncs and naked collectives
(`astlint`), and checks the kernels' build flags.  `bad_examples` seeds one
violation per rule and check.

    python -m repro_torch.audit [--self-test]
"""
from repro_torch.audit.report import Finding, Report

__all__ = ["Finding", "Report"]
