"""`correct` comes out false for the control and for every fault a cell can
have, at a tiny size on the CPU: the harness's look for a card skipped, the
rest of a run driven as the benchmark drives it (`run.run_cell`), with the
timed path broken underneath.

The faults: a step that returns its state unchanged (the activity step, and
the connectivity update); half of the batch of replicas left out; an
answer altered where it is produced (one neuron's calcium in each replica,
by one unit in the last place).  The exchange between chips does not exist
in these one-chip cells.  The control is the reference computed in
bfloat16 in the program's place (`check.compare(control=True)`)."""
import numpy as np
import pytest
import torch

import _bench_paths  # noqa: F401
import control
import run
from bench.harness import check as ck
from bench.harness import spec, traffic as tr

CELLS = ["fmm-sweep16-steady", "bh-sweep16-steady"]
TINY = {"n": 512, "domain": 172.0}
MIX = {"episode_steps": 200}
TINY_START = {"sigma": 40.0}
SEED = 31


def tiny(cell: str) -> spec.Cell:
    """The cell at 512 neurons a replica, in 200-step episodes, its start's
    synapses drawn at a kernel scaled to the tiny domain."""
    c = spec.cell(cell)
    return c._replace(config={**c.config, **TINY},
                      traffic={**c.traffic, **MIX,
                               "start": {**c.traffic["start"], **TINY_START}})


def tiny_run(cell: str, device="cpu") -> dict:
    return run.run_cell(tiny(cell), SEED, 0.5, False, device)


@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 11, 7])
def test_checked_replicas_cover_both_halves(seed):
    """The half-batch fault shows only where a checked replica lies in the
    half left out: any two intervals in a row check both halves, and 16
    intervals every replica."""
    order = tr.checked_replicas(seed, 16)
    assert sorted(order) == list(range(16))
    for a, b in zip(order, order[1:]):
        assert min(a, b) < 8 <= max(a, b)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = tiny_run(cell)
    assert result["correct"] and result["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_over_a_limit(cell):
    r = control.readings(tiny(cell), SEED, 0.5, "cpu")
    limits = spec.cell(cell).config["limits"]
    assert all(r["sound"][k] <= limits[k] for k in ck.NUMBERS)
    assert any(r["control_min"][k] > limits[k] for k in ck.NUMBERS), r


def _state_unchanged(monkeypatch):
    from repro_torch.core import ensemble
    step = ensemble.EnsembleEngine._step

    def broken(self, states, noises, rows, signs):
        new, rec = step(self, states, noises, rows, signs)
        return states._replace(step=new.step), rec
    monkeypatch.setattr(ensemble.EnsembleEngine, "_step", broken)


def _update_unchanged(monkeypatch):
    from repro_torch.core import engine
    monkeypatch.setattr(engine.PlasticityEngine, "connectivity_update",
                        lambda self, state, noise, step, params=None, n_active=None: state)


def _half_batch(monkeypatch):
    from repro_torch.core import ensemble
    activity = ensemble.activity_step

    def broken(neurons, edges, sign, u, cfg, mask=None):
        new = activity(neurons, edges, sign, u, cfg, mask)
        half = neurons.x.shape[0] // 2
        return type(new)(*(torch.cat([a[:half], b[half:]]) for a, b in zip(new, neurons)))
    monkeypatch.setattr(ensemble, "activity_step", broken)


def _answer_altered(monkeypatch):
    from repro_torch.kernels import ops
    update = ops.msp_update

    def broken(x, refrac, calcium, syn_input, uniform, cfg):
        x, refrac, spiked, ca = update(x, refrac, calcium, syn_input, uniform, cfg)
        rows = torch.arange(0, ca.shape[0], TINY["n"])
        ca = ca.clone()
        ca[rows] = torch.nextafter(ca[rows], torch.full_like(ca[rows], np.inf))
        return x, refrac, spiked, ca
    monkeypatch.setattr(ops, "msp_update", broken)


FAULTS = {"state_unchanged": _state_unchanged, "update_unchanged": _update_unchanged,
          "half_batch": _half_batch, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_comes_out_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    result = tiny_run(cell)
    assert result["correct"] is False and result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_on_the_card(card, cell):
    """The kernels' path at a tiny size, and the control against it."""
    assert tiny_run(cell, card)["correct"]
    r = control.readings(tiny(cell), SEED, 0.5, card)
    limits = spec.cell(cell).config["limits"]
    assert any(r["control_min"][k] > limits[k] for k in ck.NUMBERS)
