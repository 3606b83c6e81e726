"""The LM training path of the port against the JAX package on the CPU, for
the SSM and hybrid configs at reduced width (checks in `_torch_lm_train.py`,
as `test_torch_lm_train.py` runs them for the dense ones)."""
import pytest

from _torch_lm_train import check_loss_and_gradients, check_remat_bitwise, check_train_step
from repro import configs as jax_configs

NAMES = sorted(n for n, c in jax_configs.ARCHS.items() if c.family in ("ssm", "hybrid"))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name):
    check_loss_and_gradients(name)


@pytest.mark.parametrize("name", NAMES)
def test_remat_equals_no_remat_bitwise(name):
    check_remat_bitwise(name)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name):
    check_train_step(name)
