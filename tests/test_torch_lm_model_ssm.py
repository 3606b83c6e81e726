"""Whole models of the SSM and hybrid configs at reduced width (mamba2's
chunked scan with a ragged last chunk; zamba2's shared attention block and
its per-site caches): the port against the JAX package's forward_train,
prefill and decode from the same parameters (`_torch_lm.check_whole_model`
states the tolerances)."""
import pytest

from _torch_lm import check_whole_model


@pytest.mark.parametrize("name", ["mamba2-1.3b", "zamba2-7b"])
def test_whole_model_vs_jax(name):
    check_whole_model(name, s=40)
