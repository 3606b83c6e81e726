"""The port's work counters (`repro_torch.trace`), read after a traced run.

The port counts only while a profiler records, so the totals cover the
traced intervals and nothing else; a per-layer reader divides one total by
another, so that both sides of a ratio count the same work.  A program
without the registry has no counts: `counts()` then returns an empty dict,
and each reader returns None.
"""
from __future__ import annotations

from typing import Dict


def counts() -> Dict[str, int]:
    """Every counter's total by name ({} where the program keeps none)."""
    try:
        from repro_torch import trace
    except ImportError:
        return {}
    return trace.counts()


def ratio(num: int, den: int, scale: float = 1.0):
    """scale x num / den, or None where the denominator counted nothing."""
    return scale * num / den if den else None
