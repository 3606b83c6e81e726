"""The port's distributed engine over gloo with method="barnes_hut": the
matrix of tests/test_torch_dist_gloo.py (N = 256, 300 steps, p in {1, 2,
4}, every allowed combination of pyramid_partials and find_phase, batched
and counter draws, and a forced deletion) against the single-device port
run, bit for bit: records, spikes and the whole final state."""
import pytest

from test_torch_dist_gloo import RANKS, cases, check, run_matrix


@pytest.fixture(scope="module")
def bh_runs():
    return run_matrix("barnes_hut")


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("label", [label for label, _ in cases("barnes_hut")])
def test_barnes_hut_equals_the_single_device_run(bh_runs, p, label):
    check(*bh_runs[(p, label)], label)
