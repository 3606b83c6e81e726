"""Seeded violations: the corpus the auditor must catch, one per rule and
check, each with a corrected twin that must audit clean.

    bad.r1_record_index_add   a float index_add_ on the record path
    bad.r2_ensemble_collective a collective on the ensemble group in a step loop
    bad.r3_gather_without_excess the edge-table gather in an update without excess
    bad.r4_padded_sum         a float torch.sum over the padded neuron axis
    bad.ast_host_sync         a host .item() in the step loop
    bad.ast_naked_collective  a torch.distributed collective outside launch/mesh.py
    bad.build_fmad            nvcc flags without --fmad=false

`python -m repro_torch.audit --self-test` and tests/test_torch_audit.py run
them.
"""
from __future__ import annotations

import torch

from repro_torch.audit import astlint, rules
from repro_torch.audit.tracer import EntrySpec, Trace
from repro_torch.core import synapses

_N, _E = 96, 96 * 8


class _Local:
    """A one-rank group of the given name that runs in this process (its
    collectives return what one rank would get)."""

    def __init__(self, name: str):
        self.name, self.rank, self.size = name, 0, 1
        self.device = torch.device("cpu")

    def gather(self, x):
        return x.clone()

    def merge(self, x):
        return x.clone()


def _spikes():
    return (torch.arange(_N) % 3 == 0)


# -- R1: a record built with a float accumulation -----------------------------------

def records(spiked: torch.Tensor, tree: bool) -> torch.Tensor:
    """The spike rate, as a record path computes it."""
    if tree:
        return synapses.det_sum(spiked.to(torch.float32)) / _N
    total = torch.zeros(1).index_add_(0, torch.zeros(_N, dtype=torch.int64),
                                      spiked.to(torch.float32))
    return total[0] / _N


def _r1(tree: bool):
    return lambda trace: records(_spikes(), tree)


# -- R2: a step loop that makes a collective on the ensemble group ---------------------

def _r2(group_name: str):
    def run(trace: Trace):
        group = trace.group(_Local(group_name))
        x = torch.zeros(_N)
        for _ in range(3):              # the step loop
            x = group.merge(x + 1.0)
    return run


# -- R3: the edge-table gather in an update without excess -------------------------------

def _r3(excess: bool):
    def run(trace: Trace):
        data = trace.group(_Local("data"))
        with trace.update(excess):
            data.gather(torch.zeros(_E, dtype=torch.int32))
    return run


# -- R4: an unordered float sum over the padded neuron axis -------------------------------

def _r4(tree: bool):
    def run(trace: Trace):
        calcium = torch.linspace(0.0, 1.0, _N)
        mask = torch.arange(_N) < 64             # a padded slot's active rows
        vals = torch.where(mask, calcium, 0.0)
        return synapses.det_sum(vals) if tree else vals.sum()
    return run


# -- the source checks --------------------------------------------------------------

HOST_SYNC = '''
def simulate(state, steps):
    for _ in range(steps):
        state = step(state)
        if state.calcium.max().item() > 1.0:
            break
    return state
'''
HOST_SYNC_OK = HOST_SYNC.replace(".item() > 1.0", " > 1.0")
NAKED = '''
import torch.distributed as dist

def merge(x):
    dist.all_reduce(x)
    return x
'''
NAKED_OK = NAKED.replace("dist.all_reduce(x)", "x = group.merge(x)")
BUILD = 'FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]\n'
BUILD_OK = 'FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]\n'


def _sizes():
    return {"sizes": (_N, _E)}


def bad_examples() -> list:
    """Entry points that each seed one violation of the rule in their name."""
    return [EntrySpec("bad.r1_record_index_add", _r1(False), {"R1": {}}),
            EntrySpec("bad.r2_ensemble_collective", _r2("ensemble"),
                      {"R2": {"allowed_groups": ("data",)}}),
            EntrySpec("bad.r3_gather_without_excess", _r3(False), {"R3": {"min_size": _E}}),
            EntrySpec("bad.r4_padded_sum", _r4(False), {"R4": _sizes()})]


def clean_controls() -> list:
    """The corrected twins: each must audit clean."""
    return [EntrySpec("good.r1_record_det_sum", _r1(True), {"R1": {}}),
            EntrySpec("good.r2_data_collective", _r2("data"),
                      {"R2": {"allowed_groups": ("data",)}}),
            EntrySpec("good.r3_gather_with_excess", _r3(True), {"R3": {"min_size": _E}}),
            EntrySpec("good.r4_det_sum", _r4(True), {"R4": _sizes()})]


def source_checks() -> list:
    """(name, expected rule, findings of the bad source, findings of its twin)
    for the checks that read source text."""
    lint = lambda src: astlint.lint_source(src, "corpus.py")
    return [("bad.ast_host_sync", "AST", lint(HOST_SYNC), lint(HOST_SYNC_OK)),
            ("bad.ast_naked_collective", "AST", lint(NAKED), lint(NAKED_OK)),
            ("bad.build_fmad", "BUILD", rules.check_build_source(BUILD, "corpus.py"),
             rules.check_build_source(BUILD_OK, "corpus.py"))]


def expected_rule(name: str) -> str:
    """The rule an entry of the corpus seeds ("bad.r2_..." -> "R2")."""
    return name.split(".", 1)[1].split("_", 1)[0].upper()
