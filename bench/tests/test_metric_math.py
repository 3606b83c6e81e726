"""The per-layer metrics' arithmetic on a small profile in the recorded
format (fixtures/profile_small.json, written by hand: two chunks, nine
device operations, nine program ranges), each value worked out by hand in
the comment beside it."""
import json
from pathlib import Path

import pytest

import _bench_paths  # noqa: F401
from bench.harness import profile as pr
from bench.harness import spec

FIXTURE = Path(__file__).parent / "fixtures" / "profile_small.json"


@pytest.fixture
def rec():
    return json.loads(FIXTURE.read_text())


# name -> value by hand: ns of the ops launched in the named ranges, over
# steps (3) or replica-updates (2), in ms; or the shares described.
EXPECTED = {
    "device_ops_per_step": 3 / 2,                     # k_syn, k_neu, k_rec over 2 steps
    "synaptic_input_ms": (100 + 20) * 1e-6 / 3,
    "neurons_roofline": 100 * (1000 * 49 / 3.35e12) / ((200 + 30) * 1e-9 / 3),
    "pyramid_ms": 500 * 1e-6 / 2,
    "descend_ms": 300 * 1e-6 / 2,
    "delete_insert_ms": (40 + 200) * 1e-6 / 2,
    "idle_share": 100 * (1 - (400 + 1090) / 3000),    # busy: 50..350, 400..500 | 1090
    "peak_mem_gib": 2.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_the_fixture(rec, name):
    value = spec.metric_module(name).read({"profile": rec, "peak_bytes": 2 ** 31})
    assert value == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_with_nothing_to_read_returns_nothing(name):
    empty = {"chunks": [], "ranges": [], "ops": [], "chunk_steps": [],
             "activity_steps": 0, "replica_updates": 0, "rows": 0}
    assert spec.metric_module(name).read({"profile": empty, "peak_bytes": 0}) is None


def test_busy_and_window(rec):
    assert pr.window_s(rec) == pytest.approx(3000e-9)
    assert pr.busy_s(rec) == pytest.approx(1490e-9)


def test_top_ops_by_name(rec):
    got = {n: s for n, s in pr.top_ops(rec)}
    assert got == pytest.approx({"k_pyr": 500e-9, "k_desc": 300e-9, "k_neu": 230e-9,
                                 "k_ins": 200e-9, "k_syn": 120e-9, "k_rec": 100e-9,
                                 "k_del": 40e-9})


def test_idle_gaps_by_what_the_host_ran(rec):
    got = dict(pr.idle_gaps(rec))
    assert got == pytest.approx({
        "bench.activity (sync)": 500e-9, "traversal.descend": 300e-9,
        "update.conflicts_insert": 200e-9, "bench.update (sync)": 200e-9,
        "step.synaptic_input": 110e-9, "pyramid.sum0": 110e-9,
        "bench.activity": 50e-9, "update.delete_excess": 40e-9})
    assert sum(got.values()) == pytest.approx(pr.window_s(rec) - pr.busy_s(rec))


def test_roofline_never_passes_its_peak(rec):
    """Device time at the bandwidth floor reads 100 %; any longer, less."""
    floor_ns = 1000 * 49 / 3.35e12 * 1e9 * 3
    rec["ops"] = [o for o in rec["ops"] if o[0] != "k_neu"] + [["k_neu", 150, floor_ns, 120]]
    value = spec.metric_module("neurons_roofline").read({"profile": rec, "peak_bytes": 0})
    assert value == pytest.approx(100.0)
